"""
The port's classification postprocessing (postprocessing/
classification_postprocessing.py) against the JAX package's, byte for
byte: image- and sequence-level smoothing (plain names and taxonomy
strings, propagation through the taxonomy, same-family smoothing, 'other'
categories), the taxa-list restriction (with and without walking down),
stripping classifications from non-animals (by id and by name), merging
and combining categories, the counting helpers and the CLI. Inputs are
seeded herds: images of 3-9 animal detections whose top classes mostly
agree.
"""

import json
import os
import sys

import numpy as np
import pytest

from megadetector_tpu.postprocessing import \
    classification_postprocessing as jcp
from megadetector_tpu_torch.postprocessing import \
    classification_postprocessing as tcp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_workflow_data as wd  # noqa: E402

NAMES = ['deer', 'red fox', 'gray fox', 'other', 'canidae']


def _herds(seed, taxa):
    """Images in four folders with herds of 3-9 animal detections (and a
    person or vehicle now and then); each image has a dominant class."""

    rng = np.random.RandomState(seed)
    n_classes = len(wd.TAXA) if taxa else len(NAMES)
    images = []
    for i in range(24):
        dominant = rng.randint(n_classes)
        detections = []
        for _ in range(rng.randint(3, 10)):
            category = '1' if rng.uniform() < 0.85 else \
                str(rng.choice([2, 3]))
            det = {'category': category,
                   'conf': round(float(rng.uniform(0.05, 0.95)), 3),
                   'bbox': [round(float(v), 4)
                            for v in rng.uniform(0, 0.5, 4)]}
            top = dominant if rng.uniform() < 0.75 else \
                rng.randint(n_classes)
            scores = sorted(rng.uniform(0, 0.4, 2), reverse=True)
            first = round(float(rng.uniform(0.3, 0.99)), 3)
            others = [c for c in range(n_classes) if c != top][:2]
            det['classifications'] = [[str(top + 1), first]] + [
                [str(c + 1), round(float(s), 3)]
                for c, s in zip(others, scores)]
            detections.append(det)
        images.append({'file': 'loc{}/seq{}/im{:02d}.jpg'.format(
            i % 4, i % 3, i), 'detections': detections})
    images.append({'file': 'loc0/bad.jpg', 'failure': 'image access failure',
                   'detections': None})
    data = {'info': {'format_version': '1.4'},
            'detection_categories': dict(wd.DETECTION_CATEGORIES),
            'images': images}
    if taxa:
        data['classification_categories'] = {
            str(i + 1): t.split(';')[-1] for i, t in enumerate(wd.TAXA)}
        data['classification_category_descriptions'] = {
            str(i + 1): t for i, t in enumerate(wd.TAXA)}
    else:
        data['classification_categories'] = {
            str(i + 1): n for i, n in enumerate(NAMES)}
    return data


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp('cpp')
    paths = {'root': root}
    for name, taxa in (('plain', False), ('taxa', True)):
        paths[name] = wd.write_json(str(root / '{}.json'.format(name)),
                                    _herds(3, taxa))
    paths['taxa_list'] = str(root / 'taxa.txt')
    with open(paths['taxa_list'], 'w') as f:
        f.write('deer\ncanidae\nred fox\n\n')
    paths['taxonomy'] = wd.write_json(str(root / 'taxonomy.json'), {
        'red fox': ['vulpes', 'canidae', 'carnivora', 'mammalia'],
        'gray fox': ['urocyon', 'canidae', 'carnivora', 'mammalia'],
        'canidae': ['carnivora', 'mammalia'],
        'deer': ['cervidae', 'mammalia'],
        'white-tailed deer': ['odocoileus', 'cervidae', 'mammalia']})
    return paths


def _both(root, tag, run):
    outs = []
    for i, side in enumerate(('jax', 'port')):
        out = str(root / tag / side)
        os.makedirs(out)
        outs.append(run((jcp, tcp)[i], out))
    return outs[1], outs[0]


SMOOTHING_CASES = {
    'defaults': {},
    'same_family': {'max_detections_nondominant_class_same_family': 10000},
    'no_propagation': {'propagate_classifications_through_taxonomy': False,
                       'min_detections_to_overwrite_secondary': 3,
                       'max_detections_nondominant_class': 2},
    'loose': {'classification_confidence_threshold': 0.2,
              'detection_confidence_threshold': 0.05,
              'min_detections_to_overwrite_other': 1,
              'taxonomy_propagation_count_weight': 1.0},
}


@pytest.mark.parametrize('results', ['plain', 'taxa'])
@pytest.mark.parametrize('case', sorted(SMOOTHING_CASES))
def test_smoothing_identical(inputs, results, case):
    def run(module, out):
        options = module.ClassificationSmoothingOptions()
        for k, v in SMOOTHING_CASES[case].items():
            setattr(options, k, v)
        image = module.smooth_classification_results_image_level(
            inputs[results], os.path.join(out, 'image.json'), options)
        with open(inputs[results]) as f:
            data = json.load(f)
        by_folder = {im['file']: os.path.dirname(im['file'])
                     for im in data['images']}
        as_list = [{'file_name': fn, 'seq_id': seq}
                   for fn, seq in by_folder.items()]
        sequence = module.smooth_classification_results_sequence_level(
            inputs[results], as_list, os.path.join(out, 'seq.json'),
            options)
        module.smooth_classification_results_sequence_level(
            data, {'images': as_list}, os.path.join(out, 'seq2.json'),
            options)
        module.smooth_classification_results_sequence_level(
            inputs[results], {fn: seq.split('/')[0] for fn, seq in
                              by_folder.items() if 'im0' in fn},
            os.path.join(out, 'seq3.json'), options)
        return json.dumps([image, sequence])

    got, want = _both(inputs['root'], 'smooth_{}_{}'.format(results, case),
                      run)
    assert got == want
    wd.assert_same_tree(str(inputs['root'] / 'smooth_{}_{}'.format(
        results, case) / 'port'), str(inputs['root'] / 'smooth_{}_{}'.format(
            results, case) / 'jax'))
    with open(inputs[results]) as f:
        before = f.read()
    with open(str(inputs['root'] / 'smooth_{}_{}'.format(
            results, case) / 'port' / 'seq.json')) as f:
        assert f.read() != before


@pytest.mark.parametrize('walk_down', [False, True])
@pytest.mark.parametrize('taxonomy', [False, True])
def test_restrict_to_taxa_list_identical(inputs, walk_down, taxonomy):
    tag = 'taxa_{}_{}'.format(walk_down, taxonomy)

    def run(module, out):
        module.restrict_to_taxa_list(
            inputs['taxa_list'], inputs['taxonomy'] if taxonomy else None,
            inputs['plain'], os.path.join(out, 'restricted.json'),
            allow_walk_down=walk_down)
        return json.dumps(module.restrict_to_taxa_list(
            ['Deer', 'gray fox'], inputs['taxonomy'] if taxonomy else None,
            inputs['plain'], allow_walk_down=walk_down))

    got, want = _both(inputs['root'], tag, run)
    assert got == want
    wd.assert_same_tree(str(inputs['root'] / tag / 'port'),
                        str(inputs['root'] / tag / 'jax'))


def test_category_helpers_identical(inputs):
    def run(module, out):
        module.strip_classifications_from_nonanimal_detections(
            inputs['plain'], os.path.join(out, 'strip.json'))
        module.strip_classifications_from_nonanimal_detections(
            inputs['plain'], os.path.join(out, 'strip2.json'),
            animal_categories=('1', '2'))
        module.remove_classifications_from_non_animal_detections(
            inputs['taxa'], os.path.join(out, 'remove.json'))
        module.remove_classifications_from_non_animal_detections(
            inputs['taxa'], os.path.join(out, 'remove2.json'),
            animal_category_names=['animal', 'person'])
        module.merge_classification_categories(
            inputs['plain'], inputs['taxa'], os.path.join(out, 'merge.json'))
        with open(inputs['plain']) as f:
            data = json.load(f)
        data['classification_categories']['6'] = 'Deer'
        for im in data['images'][::2]:
            for det in im['detections'] or []:
                if det['classifications'][0][0] == '1':
                    det['classifications'][0][0] = '6'
        module.combine_redundant_classification_categories(
            data, os.path.join(out, 'combined.json'))
        options = module.ClassificationSmoothingOptions()
        counts = [module.count_detections_by_classification_category(
            im['detections'], options) for im in data['images']]
        with open(inputs['taxa']) as f:
            taxa = json.load(f)
        descriptions = [
            module.get_classification_description_string(
                module.count_detections_by_classification_category(
                    im['detections']),
                taxa['classification_category_descriptions'])
            for im in taxa['images']]
        return json.dumps([counts, descriptions])

    got, want = _both(inputs['root'], 'helpers', run)
    assert got == want
    wd.assert_same_tree(str(inputs['root'] / 'helpers' / 'port'),
                        str(inputs['root'] / 'helpers' / 'jax'))


def test_cli_identical(inputs, monkeypatch):
    seq = wd.write_json(str(inputs['root'] / 'seq_info.json'), {
        'images': [{'file_name': 'loc{}/seq{}/im{:02d}.jpg'.format(
            i % 4, i % 3, i), 'seq_id': 's{}'.format(i % 5)}
            for i in range(24)]})

    def run(module, out):
        for extra, name in (([], 'a.json'),
                            (['--sequence_information', seq], 'b.json')):
            monkeypatch.setattr(sys, 'argv', [
                'classification_postprocessing', inputs['taxa'],
                os.path.join(out, name)] + extra)
            module.main()

    _both(inputs['root'], 'cli', run)
    wd.assert_same_tree(str(inputs['root'] / 'cli' / 'port'),
                        str(inputs['root'] / 'cli' / 'jax'))
