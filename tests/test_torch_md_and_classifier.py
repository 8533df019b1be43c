"""
The port's two-stage driver (megadetector_tpu_torch/detection/
run_md_and_classifier.py and run_md_and_speciesnet.py) against the JAX
package's on the CPU, end to end on a folder of JPEGs and one short video
with torch_port_data's yolov5n detector and a tiny classifier: detections
at the golden tolerances, classification ids equal, confidences within
1e-4; taxonomy-string categories; the ensemble with a geofence, a country
and a taxonomy file; the taxonomy graph's lazy networkx; the crop queue's
batches (in flight, in input order whatever the producers' timing, so
with quantize=int8 crop_workers 1 and 4 write the same file); the CLIs.
"""

import json
import os
import sys
import threading
import time

import cv2
import numpy as np
import pytest
from PIL import Image

from megadetector_tpu.detection import run_md_and_classifier as jrun
from megadetector_tpu.detection import run_md_and_speciesnet as jsn
from megadetector_tpu.models import efficientnet as jeff
from megadetector_tpu.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.detection import run_md_and_classifier as trun
from megadetector_tpu_torch.detection import run_md_and_speciesnet as tsn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_data as data  # noqa: E402

TAXA = ['uuid1;mammalia;cetartiodactyla;cervidae;odocoileus;virginianus;'
        'white-tailed deer',
        'uuid2;mammalia;carnivora;canidae;vulpes;vulpes;red fox',
        'uuid3;mammalia;carnivora;canidae;urocyon;cinereoargenteus;'
        'gray fox',
        ';;;;;;blank']


def _sane_classifier(seed):
    cfg = jeff.EfficientNetConfig('efficientnetv2_test', num_classes=4)
    params = jeff.init_params(cfg, seed=seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                (v * np.float32(0.6) if v.ndim == 4 else v)
                for k, v in node.items()}
    params = walk(params)
    params['fc']['w'] = params['fc']['w'] * np.float32(8.0)
    return params


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    """A folder of 7 JPEGs and a 12-frame video, the detector and two
    classifiers (plain and taxonomy-string class names)."""

    root = tmp_path_factory.mktemp('two_stage')
    folder = root / 'media'
    folder.mkdir()
    imgs = data.images()
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(str(folder / 'im{}.jpg'.format(i)),
                                  quality=95)
    out = cv2.VideoWriter(str(folder / 'clip.mp4'),
                          cv2.VideoWriter_fourcc(*'mp4v'), 8, (320, 240))
    assert out.isOpened()
    for i in range(12):
        out.write(np.ascontiguousarray(np.roll(imgs[i % 4], 8 * i,
                                               axis=1)[..., ::-1]))
    out.release()
    detector = str(root / 'detector.npz')
    save_checkpoint(data.sharpened_params(imgs), detector, data.METADATA)
    classifiers = {}
    for name, names in (('plain', ['deer', 'fox', 'cow', 'other']),
                        ('taxa', TAXA)):
        path = str(root / '{}.npz'.format(name))
        save_checkpoint(_sane_classifier(3), path, {
            'arch': 'efficientnetv2_test', 'num_classes': 4,
            'class_names': names, 'image_size': 64})
        classifiers[name] = path
    taxonomy = str(root / 'taxonomy.json')
    with open(taxonomy, 'w') as f:
        json.dump([['1', 'class', 'mammalia', None],
                   ['2', 'family', 'canidae', '1'],
                   ['3', 'species', 'red fox', '2'],
                   ['4', 'species', 'gray fox', '2'],
                   ['5', 'species', 'white-tailed deer', '1']], f)
    geofence = str(root / 'geofence.json')
    with open(geofence, 'w') as f:
        json.dump({'gray fox': ['USA'], 'red fox': ['USA', 'CAN']}, f)
    return {'root': root, 'folder': str(folder), 'detector': detector,
            'classifiers': classifiers, 'taxonomy': taxonomy,
            'geofence': geofence}


def _options(module, assets, name, out, **kwargs):
    options = module.MDAndClassifierOptions()
    options.input_folder = assets['folder']
    options.output_file = str(assets['root'] / out)
    options.detector_model = assets['detector']
    options.classifier_model = assets['classifiers'][name]
    options.classification_confidence_threshold = 0.05
    options.classifiable_categories = ('1', '2', '3')
    options.classifier_batch_size = 8
    options.frame_sample = 3
    options.top_k_classifications = 3
    if module is trun:
        options.device = 'cpu'
        kwargs.setdefault('classifier_options', {'folded_stem': 'off'})
    else:
        kwargs.setdefault('classifier_options', {'folded_stem': 'off'})
    for k, v in kwargs.items():
        setattr(options, k, v)
    return options


def _compare(got, want, conf_tol=1e-4):
    """Each detection matched to one of the same category, conf within
    0.005 and bbox within 0.001 (the golden tolerances; equal confidences
    may list in either order), the same frame, and classification ids
    equal with confidences within [conf_tol]; returns the number of
    classified detections."""

    by_file = {im['file']: im for im in want['images']}
    assert sorted(by_file) == sorted(im['file'] for im in got['images'])
    n = 0
    for im in got['images']:
        ref = list(by_file[im['file']]['detections'])
        assert len(im['detections']) == len(ref), im['file']
        for d in im['detections']:
            match = [i for i, r in enumerate(ref)
                     if r['category'] == d['category'] and
                     r.get('frame_number') == d.get('frame_number') and
                     abs(d['conf'] - r['conf']) <= 0.005 and
                     np.abs(np.subtract(d['bbox'], r['bbox'])).max() <=
                     0.001]
            assert match, (im['file'], d)
            r = ref.pop(match[0])
            assert ('classifications' in d) == ('classifications' in r)
            if 'classifications' in d:
                n += 1
                assert [c[0] for c in d['classifications']] == \
                    [c[0] for c in r['classifications']]
                np.testing.assert_allclose(
                    [c[1] for c in d['classifications']],
                    [c[1] for c in r['classifications']], rtol=0,
                    atol=conf_tol)
    return n


@pytest.fixture(scope='module')
def plain_runs(assets):
    want = jrun.run_md_and_classifier(
        _options(jrun, assets, 'plain', 'jax.json'))
    options = _options(trun, assets, 'plain', 'port.json')
    got = trun.run_md_and_classifier(options)
    return got, want, options


def test_two_stage_matches_jax(plain_runs):
    got, want, options = plain_runs
    assert got['classification_categories'] == \
        want['classification_categories']
    n = _compare(got, want)
    videos = [im for im in got['images'] if im['file'].endswith('.mp4')]
    assert len(videos) == 1 and any(
        'classifications' in d for d in videos[0]['detections'])
    assert n >= 20
    with open(options.output_file) as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert set(options.step_seconds) == {'detect', 'crop', 'classify',
                                         'total'}


def test_run_md_and_speciesnet_matches_jax(assets):
    """The shim maps the reference's option names onto the two-stage
    driver, as JAX's does; overwrite handling and ignore_videos."""

    def shim_options(module, out):
        options = module.RunMDSpeciesNetOptions()
        options.source = assets['folder']
        options.output_file = str(assets['root'] / out)
        options.detector_model = assets['detector']
        options.classification_model = assets['classifiers']['plain']
        options.detection_confidence_threshold_for_output = 0.005
        options.classification_confidence_threshold = 0.05
        options.classifiable_categories = ('1', '2', '3')
        options.classifier_batch_size = 8
        options.frame_sample = 3
        options.classifier_options = {'folded_stem': 'off'}
        if module is tsn:
            options.device = 'cpu'
        return options

    want = jsn.run_md_and_speciesnet(shim_options(jsn, 'jax_shim.json'))
    got = tsn.run_md_and_speciesnet(shim_options(tsn, 'shim.json'))
    assert _compare(got, want) >= 20
    # overwrite handling: skip returns the file, error raises
    options = shim_options(tsn, 'shim.json')
    options.overwrite_handling = 'skip'
    assert tsn.run_md_and_speciesnet(options) == json.loads(json.dumps(got))
    options.overwrite_handling = 'error'
    with pytest.raises(ValueError, match='exists'):
        tsn.run_md_and_speciesnet(options)
    options = shim_options(tsn, 'shim_novideo.json')
    options.ignore_videos = True
    no_video = tsn.run_md_and_speciesnet(options)
    assert not any(im['file'].endswith('.mp4')
                   for im in no_video['images'])


def test_taxonomy_categories_and_ensemble_match_jax(assets):
    kwargs = dict(apply_ensemble=True, rollup_confidence_threshold=0.9,
                  geofence_file=assets['geofence'],
                  taxonomy_file=assets['taxonomy'], country='MEX',
                  admin1_region='SON')
    want = jrun.run_md_and_classifier(
        _options(jrun, assets, 'taxa', 'jax_taxa.json', **kwargs))
    got = trun.run_md_and_classifier(
        _options(trun, assets, 'taxa', 'port_taxa.json', **kwargs))
    for key in ('classification_categories',
                'classification_category_descriptions'):
        assert got[key] == want[key]
    assert got['classification_categories']['1'] == 'red fox'
    assert _compare(got, want) > 0


def test_taxonomy_graph_imports_networkx_lazily(assets, monkeypatch):
    """Without networkx the port imports and runs; a taxonomy graph
    raises an ImportError that names networkx."""

    from megadetector_tpu_torch.taxonomy_mapping import taxonomy_graph

    graph = taxonomy_graph.TaxonomyGraph.from_file(assets['taxonomy'])
    assert graph.id_to_node['3'].name == 'red fox'
    monkeypatch.setitem(sys.modules, 'networkx', None)
    with pytest.raises(ImportError, match='networkx'):
        taxonomy_graph.TaxonomyGraph.from_file(assets['taxonomy'])
    options = _options(trun, assets, 'taxa', 'port_nonx.json',
                       apply_ensemble=True, include_videos=False)
    assert any('classifications' in d
               for im in trun.run_md_and_classifier(options)['images']
               for d in im['detections'])
    options.taxonomy_file = assets['taxonomy']
    with pytest.raises(ImportError, match='networkx'):
        trun.run_md_and_classifier(options)


def _strip_times(d):
    d = json.loads(json.dumps(d))
    d['info'].pop('detection_completion_time', None)
    return d


def test_int8_crop_workers_1_and_4_write_the_same_file(assets):
    """Crops reach the classifier in input order, so the int8 run's
    first-batch calibration and every batch are the same whatever the
    producers' number (the JAX driver batches in arrival order)."""

    runs = []
    for workers in (1, 4):
        options = _options(trun, assets, 'plain',
                           'int8_{}.json'.format(workers),
                           classifier_options={'quantize': 'int8'},
                           crop_workers=workers)
        runs.append(_strip_times(trun.run_md_and_classifier(options)))
    assert runs[0] == runs[1]
    assert sum('classifications' in d for im in runs[0]['images']
               for d in im['detections']) >= 20


def test_crops_reach_the_queue_in_input_order_whatever_the_timing():
    """The first item's crops take longest to cut; the consumer still
    gets every item's crops in input order, in batches of the options'
    size, with one batch in flight."""

    class Recorder:
        def __init__(self):
            self.batches = []

        def classify_batch_async(self, crops, pad_to=None):
            self.batches.append([int(c) for c in crops])
            return np.eye(3, dtype=np.float32)[[int(c) % 3 for c in crops]]

        def fetch_batch(self, handle):
            return handle

        def top_k(self, p, k=5):
            return [[str(int(np.argmax(p))), 1.0]]

    options = trun.MDAndClassifierOptions()
    options.crop_workers = 4
    options.classifier_batch_size = 5
    options.crop_queue_depth = 2
    work = list(range(12))

    def crops_of(i):
        time.sleep(0.05 if i == 0 else 0.001 * (i % 3))
        return [({'i': i, 'j': j}, 10 * i + j) for j in range(i % 3)]

    recorder = Recorder()
    n = trun._classify_in_order(work, crops_of, recorder, options, {})
    flat = [c for b in recorder.batches for c in b]
    assert flat == [10 * i + j for i in work for j in range(i % 3)]
    assert n == len(flat) and all(len(b) == 5 for b in
                                  recorder.batches[:-1])


def test_consume_crop_queue_pipelined(assets):
    """_consume_crop_queue over 2 full batches and a tail classifies each
    det once, as classify_batch does on the same batches."""

    import queue

    from megadetector_tpu_torch.models.classifier import SpeciesClassifier

    classifier = SpeciesClassifier(assets['classifiers']['plain'],
                                   device='cpu')
    options = trun.MDAndClassifierOptions()
    options.classifier_batch_size = 2
    options.top_k_classifications = 2
    rng = np.random.RandomState(9)
    crops = [rng.randint(0, 255, (48, 40, 3), dtype=np.uint8)
             for _ in range(5)]
    dets = [{'category': '1', 'conf': 0.9, 'bbox': [0, 0, 1, 1]}
            for _ in crops]
    crop_q = queue.Queue()
    for det, crop in zip(dets, crops):
        crop_q.put((det, crop))
    crop_q.put(None)
    timings = {}
    assert trun._consume_crop_queue(crop_q, 1, classifier, options,
                                    timings) == 5
    assert set(timings) == {'crop', 'classify'}
    for start in (0, 2, 4):
        probs = classifier.classify_batch(crops[start:start + 2], pad_to=2)
        for det, p in zip(dets[start:start + 2], probs):
            assert det['classifications'] == classifier.top_k(p, k=2)


def test_producer_failure_still_finishes_every_turn():
    """A producer whose cutting raises puts its sentinel and finishes its
    turns, so neither the consumer nor the other producers hang."""

    options = trun.MDAndClassifierOptions()
    options.crop_workers = 3

    class Recorder:
        def __init__(self):
            self.seen = []

        def classify_batch_async(self, crops, pad_to=None):
            self.seen += list(crops)
            return np.ones((len(crops), 1), np.float32)

        def fetch_batch(self, handle):
            return handle

        def top_k(self, p, k=5):
            return [['0', 1.0]]

    def crops_of(i):
        if i == 1:
            raise RuntimeError('cut failed')
        return [({}, i)]

    recorder = Recorder()
    done = []
    thread = threading.Thread(target=lambda: done.append(
        trun._classify_in_order(list(range(7)), crops_of, recorder,
                                options, {})), daemon=True)
    thread.start()
    thread.join(30)
    assert not thread.is_alive()
    # worker 1 died at item 1: its items 1 and 4 are lost, the others
    # arrive in order
    assert recorder.seen == [0, 2, 3, 5, 6]


def test_clis_write_what_the_api_writes(assets, plain_runs):
    out = str(assets['root'] / 'cli.json')
    trun.main([assets['folder'], out, '--detector_model',
               assets['detector'], '--classifier_model',
               assets['classifiers']['plain'],
               '--classification_confidence_threshold', '0.05',
               '--classifier_batch_size', '8', '--frame_sample', '3',
               '--classifier_options', 'folded_stem=off', '--device',
               'cpu'])
    with open(out) as f:
        cli = json.load(f)
    api = trun.run_md_and_classifier(_options(
        trun, assets, 'plain', 'api.json', classifiable_categories=('1',)))
    assert _strip_times(cli) == _strip_times(api)
    out = str(assets['root'] / 'cli_shim.json')
    tsn.main([assets['folder'], out, '--detector_model', assets['detector'],
              '--classification_model', assets['classifiers']['plain'],
              '--classifier_batch_size', '8', '--ignore_videos',
              '--device', 'cpu'])
    with open(out) as f:
        assert not any(im['file'].endswith('.mp4')
                       for im in json.load(f)['images'])
    with pytest.raises(ValueError, match='classifier'):
        trun.run_md_and_classifier(trun.MDAndClassifierOptions())
