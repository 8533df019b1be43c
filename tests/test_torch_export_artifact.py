"""
The port's exported detector artifact (detection/export_detector.py) on the
CPU, beside tests/test_torch_export_detector.py (the artifact against the
live detector):

- the artifact against the JAX package's ExportedDetector on the same
  stub checkpoint, at the golden tolerances;
- the committed pico artifact (tests/data/torch_stub_golden_model.mdpkg,
  built as tests/test_mdpkg_golden.py builds JAX's: yolov5p, seed 3, the
  CPU) loads through load_detector and meets JAX's
  stub_golden_results_mdpkg.json at that test's tolerances. Regenerate
  it with MD_REGEN_GOLDENS=1;
- refusals: forbidden options, an oversize pad_batches_to or
  max_pre_nms_topk, augment, another image_size, the wrong platform,
  exporting for the card without one, tampered, missing and unhashed
  programs, a JAX .mdpkg; and JAX's loader refuses the port's artifact;
- the manifest and the programs an artifact holds.
"""

import io
import json
import os
import zipfile

import pytest
import torch

from megadetector_tpu.detection import export_detector as jax_export
from megadetector_tpu.models import yolov5 as jax_yolov5
from megadetector_tpu.models.convert_weights import \
    save_checkpoint as jax_save_checkpoint
from megadetector_tpu.utils import md_tests as jax_md_tests
from megadetector_tpu_torch.detection import export_detector as ed
from megadetector_tpu_torch.detection import run_detector
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.models.convert_weights import save_checkpoint

import test_mdpkg_golden as jax_golden
import torch_port_data as data

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
PICO_ARTIFACT = os.path.join(DATA_DIR, 'torch_stub_golden_model.mdpkg')


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_export_artifact')
    path = str(root / 'md_v5a.0.0_artifact.npz')
    save_checkpoint(data.sharpened_params(data.images()), path,
                    data.METADATA)
    return root, path


def test_artifact_matches_jax_exported_detector(tmp_path):
    """The port's artifact against JAX's on tests/test_validate_weights.py's
    kind of stub (yolov5n, seed 5), one square canvas at batch 4, at the
    golden tolerances."""

    cfg = jax_yolov5.YoloV5Config('yolov5n', num_classes=3)
    ckpt = str(tmp_path / 'stub.npz')
    jax_save_checkpoint(jax_yolov5.init_params(cfg, seed=5), ckpt, {
        'model_version_string': 'v5a.0.1', 'arch': 'yolov5n',
        'model_type': 'yolov5', 'num_classes': 3,
        'class_names': ['animal', 'person', 'vehicle'], 'image_size': 160,
        'anchors': cfg.anchors.tolist()})
    ours_path, ref_path = (str(tmp_path / n) for n in ('ours.mdpkg',
                                                       'ref.mdpkg'))
    ed.export_detector(ckpt, ours_path, batch_sizes=[4], aspects=[],
                       platforms=['cpu'])
    jax_export.export_detector(ckpt, ref_path, batch_sizes=[4], aspects=[],
                               platforms=['cpu'],
                               detector_options={'force_cpu': True})
    ours = run_detector.load_detector(ours_path, device='cpu')
    ref = jax_export.ExportedDetector(ref_path,
                                      detector_options={'force_cpu': True})
    images = jax_golden._structured_images([(160, 160)] * 4)
    ids = ['im{}.jpg'.format(i) for i in range(4)]
    got = ours.generate_detections_one_batch(images, ids,
                                             detection_threshold=0.005)
    want = ref.generate_detections_one_batch(images, ids,
                                             detection_threshold=0.005)
    options = data.golden_options()
    n = 0
    for a, b in zip(got, want):
        r = jax_md_tests.compare_detection_lists(
            b['detections'], a['detections'], options, image_id=a['file'])
        assert not r['errors'], r['errors'][:3]
        n += len(a['detections'])
    assert n > 0


def _build_pico_artifact(tmp_path):
    """tests/test_mdpkg_golden.py's pico checkpoint (a 1/8-width yolov5,
    seed 3, 128 px) exported by the port on the CPU at batch 1, the
    square canvas only."""

    yolov5.VARIANT_MULTIPLES.setdefault('p', (0.33, 0.125))
    cfg = yolov5.YoloV5Config('yolov5p', num_classes=3)
    ckpt = str(tmp_path / 'pico.npz')
    save_checkpoint(yolov5.init_params(cfg, seed=3), ckpt, {
        'arch': 'yolov5p', 'model_type': 'yolov5', 'num_classes': 3,
        'model_version_string': 'v5a.0.1',
        'class_names': ['animal', 'person', 'vehicle'],
        'image_size': jax_golden.IMAGE_SIZE,
        'anchors': cfg.anchors.tolist()})
    ed.export_detector(ckpt, PICO_ARTIFACT, batch_sizes=[1], aspects=[],
                       platforms=['cpu'])


def test_committed_pico_artifact_meets_the_jax_golden(tmp_path):
    if os.environ.get('MD_REGEN_GOLDENS'):
        _build_pico_artifact(tmp_path)
    assert os.path.isfile(PICO_ARTIFACT), \
        'Committed artifact missing; regenerate with MD_REGEN_GOLDENS=1'
    assert os.path.getsize(PICO_ARTIFACT) < 4 * 1024 * 1024
    detector = run_detector.load_detector(PICO_ARTIFACT, device='cpu')
    assert isinstance(detector, ed.ExportedDetector)
    got = jax_golden._run_pipeline(detector)
    with open(jax_golden.GOLDEN_FILE) as f:
        expected = json.load(f)
    assert len(got['images']) == len(expected['images'])
    total_exp = total_matched = 0
    for got_im, exp_im in zip(got['images'], expected['images']):
        assert got_im['file'] == exp_im['file']
        n_exp, n_matched = jax_golden._tolerant_match(
            exp_im['detections'], got_im['detections'])
        total_exp += n_exp
        total_matched += n_matched
    assert total_exp >= 5
    assert total_matched >= jax_golden.MATCH_FRACTION * total_exp


#%% Refusals


@pytest.fixture(scope='module')
def small_artifact(checkpoint):
    path = str(checkpoint[0] / 'small.mdpkg')
    ed.export_detector(checkpoint[1], path, batch_sizes=[1, 2], aspects=[],
                       topk_ladder=[512, 1024], platforms=['cpu'])
    return path


@pytest.mark.parametrize('option', ['image_size', 'dtype', 'conv_backend',
                                    'pre_nms_topk', 'fused_decode', 'arch',
                                    'mesh'])
def test_forbidden_options_are_refused(small_artifact, option):
    with pytest.raises(ValueError, match='fixed at export time'):
        run_detector.load_detector(small_artifact, device='cpu',
                                   detector_options={option: 'x'})


def test_shape_options_beyond_the_artifact_are_refused(small_artifact):
    with pytest.raises(ValueError, match='max_pre_nms_topk 2048'):
        run_detector.load_detector(
            small_artifact, device='cpu',
            detector_options={'max_pre_nms_topk': 2048})
    with pytest.raises(ValueError, match='pad_batches_to 4'):
        run_detector.load_detector(small_artifact, device='cpu',
                                   detector_options={'pad_batches_to': 4})
    with pytest.raises(ValueError, match='host-preprocess'):
        run_detector.load_detector(
            small_artifact, device='cpu',
            detector_options={'preprocess_mode': 'device'})
    detector = run_detector.load_detector(
        small_artifact, device='cpu',
        detector_options={'max_pre_nms_topk': 1024, 'pad_batches_to': 2})
    image = data.images()[0]
    with pytest.raises(ValueError, match='augment=True'):
        detector.generate_detections_one_image(image, augment=True)
    with pytest.raises(ValueError, match='image_size 320'):
        detector.generate_detections_one_image(image, image_size=320)
    # Batches larger than the largest exported one are chunked; canvases
    # not exported fall back to the square one
    results = detector.generate_detections_one_batch(data.images())
    assert all(r['detections'] is not None for r in results)
    assert {k[:4] for k in detector._programs.entries} == {
        ('forward', 2, 256, 256)}


def _rewrite(src, dst, edit):
    """Copy the archive [src] to [dst], each member through edit(name,
    bytes) -> bytes or None (dropped)."""

    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, 'w') as zout:
        for name in zin.namelist():
            blob = edit(name, zin.read(name))
            if blob is not None:
                zout.writestr(name, blob)


def test_tampered_missing_and_unhashed_programs_are_refused(small_artifact,
                                                            tmp_path):
    def flip(name, blob):
        if name.endswith('.pt2') and 'select_b2' in name:
            return blob[:-1] + bytes([blob[-1] ^ 0xFF])
        return blob

    def drop(name, blob):
        return None if 'forward_b1' in name else blob

    def unhashed(name, blob):
        return blob

    cases = ((flip, 'sha256 mismatch'), (drop, 'absent from the archive'))
    for edit, message in cases:
        path = str(tmp_path / '{}.mdpkg'.format(edit.__name__))
        _rewrite(small_artifact, path, edit)
        with pytest.raises(ValueError, match=message):
            run_detector.load_detector(path, device='cpu')
    path = str(tmp_path / 'extra.mdpkg')
    _rewrite(small_artifact, path, unhashed)
    with zipfile.ZipFile(path, 'a') as z:
        z.writestr('programs/cpu/extra.pt2', b'x')
    with pytest.raises(ValueError, match='no integrity hash'):
        run_detector.load_detector(path, device='cpu')


def test_platforms(small_artifact, tmp_path, checkpoint):
    def cuda_only(name, blob):
        if name != ed.MANIFEST_NAME:
            return blob
        manifest = json.loads(blob)
        manifest['platforms'] = ['cuda']
        return json.dumps(manifest).encode()

    path = str(tmp_path / 'cuda_only.mdpkg')
    _rewrite(small_artifact, path, cuda_only)
    with pytest.raises(ValueError, match='exported for platform'):
        run_detector.load_detector(path, device='cpu')
    assert ed.canonical_platforms(['gpu', 'cpu', 'cuda']) == ['cuda', 'cpu']
    assert ed.canonical_platforms(None) == ['cuda']
    assert ed.canonical_platforms(None, force_cpu=True) == ['cpu']
    with pytest.raises(ValueError, match='Unknown platform'):
        ed.canonical_platforms(['tpu'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            ed.export_detector(checkpoint[1], str(tmp_path / 'x.mdpkg'),
                               batch_sizes=[1], aspects=[],
                               platforms=['cuda'])


def test_each_package_refuses_the_others_artifact(small_artifact):
    jax_artifact = os.path.join(DATA_DIR, 'stub_golden_model.mdpkg')
    with pytest.raises(ValueError, match='JAX artifact'):
        run_detector.load_detector(jax_artifact, device='cpu')
    with pytest.raises(AssertionError, match='format version'):
        jax_export.ExportedDetector(small_artifact,
                                    detector_options={'force_cpu': True})


def test_manifest_and_programs(small_artifact):
    manifest, blobs = ed.read_artifact(small_artifact)
    assert manifest['batch_sizes'] == [1, 2]
    assert manifest['topk_ladder'] == [512, 1024]
    assert manifest['platforms'] == ['cpu']
    assert sorted(blobs) == sorted(manifest['program_sha256'])
    assert sorted(blobs) == [
        'programs/cpu/forward_b1_h256_w256.pt2',
        'programs/cpu/forward_b2_h256_w256.pt2',
        'programs/cpu/select_b1_h256_w256_k1024.pt2',
        'programs/cpu/select_b1_h256_w256_k512.pt2',
        'programs/cpu/select_b2_h256_w256_k1024.pt2',
        'programs/cpu/select_b2_h256_w256_k512.pt2']
    program = torch.export.load(io.BytesIO(
        blobs['programs/cpu/select_b2_h256_w256_k512.pt2']))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == 'call_function']
    # The NMS is one node (its loop over K is not unrolled), and no
    # decomposition ran: sigmoid stays one op
    assert targets.count('mdtorch.greedy_nms_keep_t.default') == 1
    assert 'aten.sigmoid.default' in targets
    assert len(targets) < 300
