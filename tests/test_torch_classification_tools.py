"""
The port's copies of the classifier-training workflow's host tools
against the JAX package's, on the same inputs, byte for byte (time
fields masked): csv_to_json, json_validator (the spec's refusals, the
local image source, sampling with priority, multilabel, min_locs, the
taxonomy route, known-mislabeled images), cache_batchapi_outputs (the
merge, a version mismatch, a Batch API response through fetch_fn),
aggregate_classifier_probs, map_classification_categories (the pair and
TaxonNode routes, partial overlap), merge_classification_detection_output
(predictions, the label-only merge, the reference's functions),
identify_mislabeled_candidates, save_mislabeled and analyze_failed_images
(threads, the truncated-image flag restored), and their CLIs. Inputs come
from tests/torch_cct_data.py and are written here.
"""

import csv
import copy
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image, ImageFile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_cct_data as cd  # noqa: E402

CSV_TO_JSON = cd.pair('classification.csv_to_json')
VALIDATOR = cd.pair('classification.json_validator')
CACHE = cd.pair('classification.cache_batchapi_outputs')
AGGREGATE = cd.pair('classification.aggregate_classifier_probs')
MAP = cd.pair('classification.map_classification_categories')
MERGE = cd.pair('classification.merge_classification_detection_output')
MISLABELED = cd.pair('classification.identify_mislabeled_candidates')
SAVE = cd.pair('classification.save_mislabeled')
FAILED = cd.pair('classification.analyze_failed_images')
GRAPH = cd.pair('taxonomy_mapping.taxonomy_graph')

SPEC_CSV = """# the label spec
output_label,type,content
cervid,row,ds1|deer
cervid,row,ds1|elk
cervid,row,ds2|deer
cervid,max_count,5
cervid,prioritize,"[['ds2']]"
cervid,family,cervidae
cervid,datasettaxon,ds1|family|cervidae
canid,row,ds1|fox
canid,row,ds2|wolf
!canid,row,ds1|coyote
"""
TAXONOMY_CSV = """taxon_id,level,name,parent_id
1,family,Cervidae,
2,genus,Odocoileus,1
3,species,deer,2
4,species,elk,1
5,family,Canidae,
6,species,fox,5
7,species,wolf,5
"""


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """A local image source over seeded JPEGs of two datasets (four
    locations each; one listed image missing on disk, one not an image),
    a label spec CSV and a taxonomy CSV."""

    root = tmp_path_factory.mktemp('clf_tools')
    images = root / 'images'
    rng = np.random.RandomState(0)
    source = {}
    classes = {'ds1': ['deer', 'elk', 'fox', 'coyote'],
               'ds2': ['deer', 'wolf']}
    for ds, names in classes.items():
        for i in range(14):
            rel = '{}/loc{}/img_{:02d}.jpg'.format(ds, i % 4, i)
            if i != 13:
                (images / rel).parent.mkdir(parents=True, exist_ok=True)
                Image.fromarray(rng.randint(0, 256, (24, 32, 3),
                                            np.uint8)).save(str(images / rel))
            source[rel] = {'dataset': ds, 'class': names[i % len(names)],
                           'location': 'loc{}'.format(i % 4)}
    source['ds1/loc0/notes.txt'] = {'dataset': 'ds1', 'class': 'deer',
                                    'location': 'loc0'}
    paths = {'images': str(images)}
    for name, text in (('spec_csv', SPEC_CSV), ('taxonomy', TAXONOMY_CSV)):
        paths[name] = str(root / (name + '.csv'))
        with open(paths[name], 'w') as f:
            f.write(text)
    paths['source'] = str(root / 'source.json')
    with open(paths['source'], 'w') as f:
        json.dump(source, f, indent=1)
    spec = CSV_TO_JSON[0].csv_to_jsondict(paths['spec_csv'])
    spec = {k: CSV_TO_JSON[0].order_spec_dict(v) for k, v in spec.items()}
    paths['spec'] = str(root / 'spec.json')
    with open(paths['spec'], 'w') as f:
        json.dump(spec, f)
    return dict(paths, root=root, source_data=source, spec_data=spec)


#%% csv_to_json


def test_csv_to_jsondict_and_order_identical(world):
    outs = [m.csv_to_jsondict(world['spec_csv']) for m in CSV_TO_JSON]
    assert outs[1] == outs[0]
    assert outs[1]['cervid']['prioritize'] == [['ds2']]
    assert outs[1]['canid']['exclude']['dataset_labels']['ds1'] == \
        ['coyote']
    for label in outs[0]:
        ordered = [m.order_spec_dict(copy.deepcopy(outs[0][label]))
                   for m in CSV_TO_JSON]
        assert list(ordered[1].items()) == list(ordered[0].items())


@pytest.mark.parametrize('indent', [None, 1])
def test_csv_to_json_cli_identical(world, tmp_path, monkeypatch, indent):
    def run(side, out):
        monkeypatch.setattr(sys, 'argv', [
            'csv_to_json', world['spec_csv'], os.path.join(out, 'spec.json')]
            + ([] if indent is None else ['--json-indent', str(indent)]))
        CSV_TO_JSON[side].main()

    (_, got), (_, want) = cd.both(tmp_path, 'cli', run)
    cd.assert_same_tree(got, want)


def test_csv_to_json_refuses_other_columns(tmp_path):
    path = str(tmp_path / 'bad.csv')
    with open(path, 'w') as f:
        f.write('label,type,content\nx,row,a|b\n')
    messages = []
    for module in CSV_TO_JSON:
        with pytest.raises(AssertionError) as info:
            module.csv_to_jsondict(path)
        messages.append(str(info.value))
    assert messages[1] == messages[0]


#%% json_validator


def _log_renamed(folder):
    """The validator's log file under a fixed name (its own carries the
    time it was written)."""

    (log,) = [f for f in os.listdir(folder)
              if f.startswith('json_validator_log_')]
    os.rename(os.path.join(folder, log),
              os.path.join(folder, 'json_validator_log.json'))


VALIDATOR_CASES = {
    'sampled': {},
    'images_dir': {'images_dir': True},
    'min_locs': {'min_locs': 4, 'images_dir': True},
    'multilabel': {'allow_multilabel': True, 'extra': {
        'any_deer': {'dataset_labels': {'ds1': ['deer']}}}},
    'seed': {'seed': 5},
    'taxonomy': {'taxonomy': True},
}


@pytest.mark.parametrize('case', sorted(VALIDATOR_CASES))
def test_run_validator_identical(world, tmp_path, case, capsys):
    settings = VALIDATOR_CASES[case]
    spec_path = world['spec']
    spec = copy.deepcopy(world['spec_data'])
    if not settings.get('taxonomy'):
        for label in spec:
            spec[label].pop('taxa', None)
    spec.update(settings.get('extra', {}))
    spec_path = str(tmp_path / 'spec.json')
    with open(spec_path, 'w') as f:
        json.dump(spec, f)

    def run(side, out):
        value = VALIDATOR[side].run_validator(
            spec_path, world['source'],
            world['taxonomy'] if settings.get('taxonomy') else None, out,
            allow_multilabel=settings.get('allow_multilabel', False),
            min_locs=settings.get('min_locs'),
            images_dir=world['images'] if settings.get('images_dir')
            else None, seed=settings.get('seed', 123))
        _log_renamed(out)
        return value, capsys.readouterr().out

    (ours, got), (ref, want) = cd.both(tmp_path, 'validator', run)
    assert ours == ref
    cd.assert_same_tree(got, want)
    counts = [json.load(open(os.path.join(got, name))) for name in (
        'image_counts_by_label_presample.json',
        'image_counts_by_label_sampled.json')]
    if case == 'multilabel':
        # the uncapped label keeps cervid's multilabel images: a warning
        assert counts[1]['cervid'] > 5 and 'Warning: label cervid' in ours[1]
    elif case != 'min_locs':
        # max_count 5 sampled cervid down
        assert counts[0]['cervid'] > 5 >= counts[1]['cervid']
    assert not any(p.endswith('.txt') for p in ours[0])


def test_run_validator_without_source_or_output_identical(world):
    spec = copy.deepcopy(world['spec_data'])
    for label in spec:
        spec[label].pop('taxa', None)
    outs = [m.run_validator(world['spec'], taxonomy_csv_path=world[
        'taxonomy']) for m in VALIDATOR]
    assert outs[1] == outs[0] and ('ds1', 'deer') in outs[0]['cervid']
    outs = [m.run_validator(world['spec'], world['source'],
                            world['taxonomy']) for m in VALIDATOR]
    assert outs[1] == outs[0]


@pytest.mark.parametrize('seed', [0, 1, 123])
def test_sample_with_priority_identical(world, seed):
    spec = {'cervid': {'dataset_labels': {'ds1': ['deer', 'elk'],
                                          'ds2': ['deer']},
                       'max_count': 6, 'prioritize': [['ds2']]},
            'canid': {'dataset_labels': {'ds1': ['fox'], 'ds2': ['wolf']},
                      'max_count': 3},
            'both': {'dataset_labels': {'ds1': ['elk']}}}
    outs = []
    for module in VALIDATOR:
        inclusions = module.validate_json(spec, allow_multilabel=True)
        output_js = module.build_queried_images(inclusions,
                                                world['source_data'])
        outs.append(module.sample_with_priority(spec, output_js, seed=seed))
    assert outs[1] == outs[0]
    assert list(outs[1]) == list(outs[0])


SPEC_REFUSALS = {
    'conflict': {'a': {'dataset_labels': {'ds1': ['deer']}},
                 'b': {'dataset_labels': {'ds1': ['deer', 'elk']}}},
    'prioritize': {'a': {'dataset_labels': {'ds1': ['deer']},
                         'prioritize': [['ds1']]}},
    'empty': {'a': {}},
    'taxon': {'a': {'taxa': [{'level': 'family', 'name': 'ursidae',
                              'datasets': ['ds1']}]}},
}


@pytest.mark.parametrize('case', sorted(SPEC_REFUSALS))
def test_validate_json_refusals_identical(world, case):
    messages = []
    for module, graph in zip(VALIDATOR, GRAPH):
        taxonomy = graph.build_taxonomy_from_csv(world['taxonomy'])
        with pytest.raises(ValueError) as info:
            module.validate_json(SPEC_REFUSALS[case], taxonomy)
        messages.append(str(info.value))
    assert messages[1] == messages[0]


def test_get_output_json_and_mislabeled_identical(world, tmp_path, capsys):
    inclusions = {'cervid': {('ds1', 'deer'), ('ds1', 'elk')},
                  'canid': {('ds2', 'wolf')}}
    folder = tmp_path / 'megadb_mislabeled'
    folder.mkdir()
    (folder / 'ds1.csv').write_text(
        'file,correct_class\nloc0/img_00.jpg,elk\nloc1/img_05.jpg,\n')
    (folder / 'ds2.txt').write_text('ignored')
    for mislabeled in (None, str(folder)):
        outs = []
        for module in VALIDATOR:
            outs.append((module.get_output_json(
                inclusions, mislabeled, world['source_data']),
                capsys.readouterr().out))
        assert outs[1] == outs[0]
        assert list(outs[1][0]) == list(outs[0][0])
    assert 'ds1/loc0/img_00.jpg' not in outs[0][0]


#%% cache_batchapi_outputs


def _md(files, version='5a.0.0'):
    return {'info': {'format_version': '1.6',
                     'detector': 'md_v{}'.format(version)},
            'detection_categories': {'1': 'animal'},
            'images': [{'file': f, 'detections': [
                {'category': '1', 'conf': 0.9,
                 'bbox': [0.1, 0.1, 0.2, 0.2]}]} for f in files]}


def test_cache_batchapi_outputs_identical(tmp_path, capsys):
    first = str(tmp_path / 'first.json')
    second = str(tmp_path / 'second.json')
    with open(first, 'w') as f:
        json.dump(_md(['a.jpg', 'b.jpg']), f)
    with open(second, 'w') as f:
        json.dump(_md(['b.jpg', 'c.jpg']), f)

    def run(side, out):
        messages = [CACHE[side].cache_json(
            path, True, 'ds1', out, detector_version=version)
            for path, version in ((first, None), (second, '5a.0.0'))]
        messages.append(CACHE[side].cache_detections(
            _md(['d.jpg']), 'ds2', os.path.join(out, 'v5a.0.0')))
        return cd.relative((messages, capsys.readouterr().out), out)

    (ours, got), (ref, want) = cd.both(tmp_path, 'cache', run)
    assert ours == ref and 'Merging' in ours[0][1]
    cd.assert_same_tree(got, want)
    with open(os.path.join(got, 'v5a.0.0', 'ds1.json')) as f:
        assert sorted(im['file'] for im in json.load(f)['images']) == \
            ['a.jpg', 'b.jpg', 'c.jpg']


def test_cache_batchapi_outputs_responses_and_refusals_identical(tmp_path):
    det_file = str(tmp_path / 'det.json')
    with open(det_file, 'w') as f:
        json.dump(_md(['a.jpg']), f)
    response = {'TaskId': 'task7', 'Status': {
        'request_status': 'completed', 'message': {'output_file_urls': {
            'detections': 'https://example.invalid/task7/det.json'}}}}
    resp_file = str(tmp_path / 'resp.json')
    with open(resp_file, 'w') as f:
        json.dump(response, f)
    pending = str(tmp_path / 'pending.json')
    with open(pending, 'w') as f:
        json.dump(dict(response, Status=dict(response['Status'],
                                             request_status='running')), f)

    def run(side, out):
        fetched = []

        def fetch(url):
            fetched.append(url)
            return _md(['r.jpg'], '4.1')

        message = CACHE[side].cache_json(resp_file, False, 'ds1', out,
                                         fetch_fn=fetch)
        refusals = []
        for args, kwargs, error in (
                ((det_file, True, 'ds1', out), {'detector_version': '4.1'},
                 AssertionError),
                ((resp_file, False, 'ds1', out), {}, RuntimeError),
                ((pending, False, 'ds1', out), {'fetch_fn': fetch},
                 AssertionError)):
            with pytest.raises(error) as info:
                CACHE[side].cache_json(*args, **kwargs)
            refusals.append(str(info.value))
        return cd.relative(message, out), fetched, refusals

    (ours, got), (ref, want) = cd.both(tmp_path, 'responses', run)
    assert ours == ref
    assert ours[1] == ['https://example.invalid/task7/det.json']
    cd.assert_same_tree(got, want)


def test_cache_batchapi_outputs_cli_identical(tmp_path, monkeypatch):
    det_file = str(tmp_path / 'det.json')
    with open(det_file, 'w') as f:
        json.dump(_md(['a.jpg']), f)

    def run(side, out):
        monkeypatch.setattr(sys, 'argv', [
            'cache_batchapi_outputs', det_file, '-f', 'detections', '-d',
            'dsx', '-c', out, '-v', '5a.0.0'])
        CACHE[side].main()

    (_, got), (_, want) = cd.both(tmp_path, 'cli', run)
    cd.assert_same_tree(got, want)


#%% aggregate_classifier_probs


def _probs_csv(path, labels, n=9, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, 'w') as f:
        f.write(','.join(['path'] + labels) + '\n')
        for i in range(n):
            p = rng.dirichlet(np.ones(len(labels)))
            f.write(','.join(['ds/im{}.jpg___crop00.jpg'.format(i)] +
                             ['{!r}'.format(float(v)) for v in p]) + '\n')
    return path


@pytest.mark.parametrize('with_index', [True, False])
def test_aggregate_classifier_probs_identical(tmp_path, with_index):
    probs = _probs_csv(str(tmp_path / 'probs.csv'),
                       ['deer', 'elk', 'wolf', 'fox', 'cow'])
    mapping = str(tmp_path / 'mapping.json')
    with open(mapping, 'w') as f:
        json.dump({'cervid': ['deer', 'elk'], 'canid': ['wolf', 'fox'],
                   'other': ['cow']}, f)

    def run(side, out):
        return AGGREGATE[side].aggregate_classifier_probs(
            probs, mapping, os.path.join(out, 'agg.csv'),
            os.path.join(out, 'index.json') if with_index else None)

    (ours, got), (ref, want) = cd.both(tmp_path, 'agg', run)
    assert ours == ref == ['canid', 'cervid', 'other']
    cd.assert_same_tree(got, want)
    with open(os.path.join(got, 'agg.csv')) as f:
        rows = list(csv.reader(f))[1:]
    assert all(abs(sum(float(v) for v in r[1:]) - 1) < 1e-5 for r in rows)


@pytest.mark.parametrize('mapping', [
    {'cervid': ['deer', 'elk'], 'x': ['elk', 'wolf', 'fox', 'cow']},
    {'cervid': ['deer', 'elk'], 'canid': ['wolf', 'fox']}])
def test_aggregate_classifier_probs_refusals_identical(tmp_path, mapping):
    probs = _probs_csv(str(tmp_path / 'probs.csv'),
                       ['deer', 'elk', 'wolf', 'fox', 'cow'])
    path = str(tmp_path / 'mapping.json')
    with open(path, 'w') as f:
        json.dump(mapping, f)
    messages = []
    for module in AGGREGATE:
        with pytest.raises(AssertionError) as info:
            module.aggregate_classifier_probs(
                probs, path, str(tmp_path / 'out.csv'))
        messages.append(str(info.value))
    assert messages[1] == messages[0]


def test_aggregate_classifier_probs_cli_identical(tmp_path, monkeypatch):
    probs = _probs_csv(str(tmp_path / 'probs.csv'), ['a', 'b', 'c'])
    mapping = str(tmp_path / 'mapping.json')
    with open(mapping, 'w') as f:
        json.dump({'x': ['a'], 'y': ['b', 'c']}, f)

    def run(side, out):
        monkeypatch.setattr(sys, 'argv', [
            'aggregate_classifier_probs', probs, mapping,
            os.path.join(out, 'o.csv'), '--output_label_index',
            os.path.join(out, 'i.json')])
        AGGREGATE[side].main()

    (_, got), (_, want) = cd.both(tmp_path, 'cli', run)
    cd.assert_same_tree(got, want)


#%% map_classification_categories

CLASSIFIER_SPEC = {
    'deer': {'dataset_labels': {'ds1': ['deer'], 'ds2': ['deer']}},
    'elk': {'dataset_labels': {'ds1': ['elk']}},
    'wolf': {'dataset_labels': {'ds2': ['wolf']}},
    'fox': {'dataset_labels': {'ds1': ['fox']}},
}
MAP_CASES = {
    'two_targets': {'cervid': {'dataset_labels': {
        'ds1': ['deer', 'elk'], 'ds2': ['deer']}},
        'canid': {'dataset_labels': {'ds1': ['fox'], 'ds2': ['wolf']}}},
    'other': {'cervid': {'dataset_labels': {
        'ds1': ['deer', 'elk', 'moose'], 'ds2': ['deer']}}},
    'taxa': {'cervid': {'taxa': [{'level': 'family', 'name': 'cervidae',
                                  'datasets': ['ds1', 'ds2']}]}},
}


@pytest.mark.parametrize('case', sorted(MAP_CASES))
def test_map_classification_categories_identical(world, case):
    outs = []
    for module, graph in zip(MAP, GRAPH):
        taxonomy = graph.build_taxonomy_from_csv(world['taxonomy']) \
            if case == 'taxa' else None
        outs.append(module.map_classification_categories(
            MAP_CASES[case], CLASSIFIER_SPEC, taxonomy))
    assert outs[1] == outs[0]
    assert list(outs[1]) == list(outs[0])
    if case == 'two_targets':
        assert outs[0] == {'cervid': ['deer', 'elk'],
                           'canid': ['fox', 'wolf']}


@pytest.mark.parametrize('desired,error', [
    ({'weird': {'dataset_labels': {'ds1': ['deer', 'bear']}}}, ValueError),
    ({'a': {'dataset_labels': {'ds1': ['elk']}},
      'b': {'dataset_labels': {'ds1': ['elk', 'fox']}}}, ValueError),
    ({'other': {'dataset_labels': {'ds1': ['elk']}}}, AssertionError)])
def test_map_classification_categories_refusals_identical(desired, error):
    messages = []
    for module in MAP:
        with pytest.raises(error) as info:
            module.map_classification_categories(desired, CLASSIFIER_SPEC)
        messages.append(str(info.value))
    assert messages[1] == messages[0]


def _nodes(graph_module):
    """A taxonomy of TaxonNodes from [graph_module] and the lookups of
    the TaxonNode route."""

    import networkx as nx

    g = nx.DiGraph()
    node = graph_module.TaxonNode
    family = node('family', 'cervidae', graph=g)
    genus = node('genus', 'odocoileus', graph=g)
    species = node('species', 'odocoileus virginianus', graph=g)
    felid = node('family', 'felidae', graph=g)
    genus.add_parent(family)
    species.add_parent(genus)
    taxon_to_node = {('family', 'cervidae'): family,
                     ('genus', 'odocoileus'): genus,
                     ('species', 'odocoileus virginianus'): species,
                     ('family', 'felidae'): felid}
    label_to_node = {('ds1', 'deer'): genus, ('ds1', 'cat'): felid}
    return taxon_to_node, label_to_node


def _names(value):
    if isinstance(value, dict):
        return {k: _names(v) for k, v in value.items()}
    return sorted((n.level, n.name) for n in value)


NODE_SPECS = {
    'family': {'deer': {'taxa': [{'level': 'Family', 'name': 'Cervidae'}]},
               'cat': {'dataset_labels': {'DS1': ['cat']}}},
    'exclude': {'deer': {'taxa': [{'level': 'family', 'name': 'cervidae'}],
                         'exclude': {'taxa': [{
                             'level': 'species',
                             'name': 'odocoileus virginianus'}]}}},
    'unknown_skipped': {'deer': {'taxa': [
        {'level': 'family', 'name': 'nosuch'},
        {'level': 'genus', 'name': 'odocoileus'}]}},
}


@pytest.mark.parametrize('case', sorted(NODE_SPECS))
def test_taxon_node_route_identical(case, capsys):
    outs = []
    for module, graph in zip(MAP, GRAPH):
        taxon_to_node, label_to_node = _nodes(graph)
        nodes = module.label_spec_to_nodes(NODE_SPECS[case], taxon_to_node,
                                           label_to_node)
        target = {'cervids': set(module.parse_spec(
            {'taxa': [{'level': 'family', 'name': 'cervidae'}]},
            taxon_to_node, label_to_node))}
        outs.append((_names(nodes), module.map_target_to_classifier(
            target, nodes), capsys.readouterr().out))
    assert outs[1] == outs[0]


def test_taxon_node_route_refusals_identical(capsys):
    messages = []
    for module, graph in zip(MAP, GRAPH):
        taxon_to_node, label_to_node = _nodes(graph)
        genus = taxon_to_node[('genus', 'odocoileus')]
        species = taxon_to_node[('species', 'odocoileus virginianus')]
        for call in (
                lambda: module.parse_spec(
                    {'taxa': [{'level': 'family', 'name': 'nosuch'}]},
                    taxon_to_node, label_to_node),
                lambda: module.label_spec_to_nodes(
                    {'a': {'taxa': [{'level': 'family',
                                     'name': 'cervidae'}]},
                     'b': {'taxa': [{'level': 'genus',
                                     'name': 'odocoileus'}]}},
                    taxon_to_node, label_to_node),
                lambda: module.map_target_to_classifier(
                    {'deer': {genus}}, {'odocoileus': {genus, species}})):
            with pytest.raises(ValueError) as info:
                call()
            messages.append(str(info.value).split(': {')[0])
    capsys.readouterr()
    assert messages[3:] == messages[:3]


@pytest.mark.parametrize('taxonomy', [False, True])
def test_map_classification_categories_cli_identical(world, tmp_path,
                                                     monkeypatch, taxonomy,
                                                     capsys):
    desired = str(tmp_path / 'desired.json')
    classifier = str(tmp_path / 'classifier.json')
    with open(desired, 'w') as f:
        json.dump(MAP_CASES['taxa' if taxonomy else 'two_targets'], f)
    with open(classifier, 'w') as f:
        json.dump(CLASSIFIER_SPEC, f)

    def run(side, out):
        monkeypatch.setattr(sys, 'argv', [
            'map_classification_categories', desired, classifier,
            os.path.join(out, 'map.json')] +
            (['--taxonomy_csv', world['taxonomy']] if taxonomy else []))
        MAP[side].main()
        return cd.relative(capsys.readouterr().out, out)

    (ours, got), (ref, want) = cd.both(tmp_path, 'cli', run)
    assert ours == ref
    cd.assert_same_tree(got, want)


#%% merge_classification_detection_output

LABELS = ['cervid', 'canid', 'other']


@pytest.fixture(scope='module')
def merge_world(tmp_path_factory):
    """A detections file over 6 images, an evaluation outputs CSV and a
    dataset CSV of crops of them, and a label index."""

    root = tmp_path_factory.mktemp('merge_world')
    rng = np.random.RandomState(1)
    images = []
    for i in range(6):
        images.append({'file': 'ds1/loc{}/im{}.jpg'.format(i % 2, i),
                       'detections': [
                           {'category': '1', 'conf': round(0.9 - 0.1 * j, 3),
                            'bbox': [round(float(v), 4) for v in
                                     rng.uniform(0.05, 0.4, 4)]}
                           for j in range(3)]})
    images.append({'file': 'ds1/loc0/failed.jpg', 'failure': 'bad',
                   'detections': None})
    detections = {'info': {'format_version': '1.6', 'detector': 'md_v5a.0.0'},
                  'detection_categories': {'1': 'animal'}, 'images': images}
    paths = {'detections': str(root / 'detections.json')}
    with open(paths['detections'], 'w') as f:
        json.dump(detections, f)
    paths['index'] = str(root / 'label_index.json')
    with open(paths['index'], 'w') as f:
        json.dump({str(i): n for i, n in enumerate(LABELS)}, f)
    outputs, dataset = [], []
    for i in range(6):
        for j in range(2 if i % 3 else 3):
            crop = '{}___crop{:02d}_mdv5a.0.0.jpg'.format(images[i]['file'],
                                                         j)
            p = rng.dirichlet(np.ones(3))
            label = LABELS[rng.randint(0, 3)]
            outputs.append([crop, label, '1.0'] +
                           ['{!r}'.format(float(v)) for v in p])
            dataset.append([crop, 'ds1', 'loc{}'.format(i % 2), 'deer',
                            '0.9', label])
    outputs.append(['ds1/loc0/im0.jpg___crop07_mdv5a.0.0.jpg', 'cervid',
                    '1.0', '0.5', '0.25', '0.25'])
    outputs.append(['ds1/loc0/nowhere.jpg___crop00_mdv5a.0.0.jpg', 'cervid',
                    '1.0', '0.5', '0.25', '0.25'])
    for name, header, rows in (
            ('outputs', ['path', 'label', 'weight'] + LABELS, outputs),
            ('dataset', ['path', 'dataset', 'location', 'dataset_class',
                         'confidence', 'label'], dataset)):
        paths[name] = str(root / (name + '.csv'))
        with open(paths[name], 'w') as f:
            f.write(','.join(header) + '\n')
            for row in rows:
                f.write(','.join(row) + '\n')
    return paths


MERGE_CASES = {
    'preds': ('outputs', {}),
    'preds_no_index': ('outputs', {'label_index_path': None}),
    'threshold_top_k': ('outputs', {'threshold': 0.3, 'top_k': 2}),
    'label_first': ('outputs', {'label_first': True,
                                'classifier_name': 'v2s'}),
    'label_only': ('dataset', {}),
}


@pytest.mark.parametrize('case', sorted(MERGE_CASES))
def test_merge_classification_detection_output_identical(
        merge_world, tmp_path, case, capsys):
    source, kwargs = MERGE_CASES[case]
    kwargs = dict({'label_index_path': merge_world['index']}, **kwargs)

    def run(side, out):
        value = MERGE[side].merge_classification_detection_output(
            merge_world[source], merge_world['detections'],
            os.path.join(out, 'sub', 'merged.json'), **kwargs)
        return cd.relative(value, out), cd.relative(capsys.readouterr().out,
                                                    out)

    (ours, got), (ref, want) = cd.both(tmp_path, 'merge', run)
    mask = ('classification_completion_time',)
    assert cd.masked(ours, mask) == cd.masked(ref, mask)
    cd.assert_same_tree(got, want, mask)
    merged = ours[0]
    n = sum('classifications' in d for im in merged['images']
            for d in im['detections'] or [])
    assert n == 14
    if case == 'label_only':
        assert all(len(d['classifications']) == 1 and
                   int(d['classifications'][0][0]) >= 1000000
                   for im in merged['images'] for d in im['detections'] or []
                   if 'classifications' in d)


def test_merge_reference_functions_identical(merge_world, tmp_path):
    import pandas as pd

    from megadetector_tpu.utils import ct_utils

    cache = tmp_path / 'cache' / 'v5a.0.0'
    cache.mkdir(parents=True)
    with open(merge_world['detections']) as f:
        detections = json.load(f)
    ct_utils.write_json(str(cache / 'ds1.json'), dict(detections, images=[
        dict(im, file=im['file'].split('/', 1)[1])
        for im in detections['images']]))
    queried = {'ds1/loc1/gt.jpg': {'dataset': 'ds1', 'class': 'deer',
                                   'label': ['cervid'], 'bbox': [
                                       {'category': 'animal',
                                        'bbox': [0.1, 0.1, 0.5, 0.5]}]}}
    queried_path = str(tmp_path / 'queried.json')
    ct_utils.write_json(queried_path, queried)
    df = pd.read_csv(merge_world['outputs'], index_col='path').iloc[:6]
    df = pd.concat([df, pd.DataFrame(
        {'label': ['cervid'], 'weight': [1.0], 'cervid': [0.6],
         'canid': [0.3], 'other': [0.1]},
        index=['ds1/loc1/gt.jpg___crop00.jpg'])])
    outs = []
    for module in MERGE:
        rows = [module.row_to_classification_list(
            row, LABELS, True, pos, threshold, relative)
            for _, row in df.iterrows()
            for pos, threshold, relative in (('last', 0.2, False),
                                             ('first', 0.0, True),
                                             (None, 0.0, False))]
        js = module.process_queried_images(
            df, queried_path, str(tmp_path / 'cache'), '5a.0.0')
        merged = module.combine_classification_with_detection(
            copy.deepcopy(js), df, {str(i): n for i, n in enumerate(LABELS)},
            LABELS, 'clf', 'now', 0.1, label_pos='last',
            typical_confidence_threshold=0.4)
        sampled = module.process_queried_images(
            df, queried_path, str(tmp_path / 'cache'), '5a.0.0',
            datasets=['ds1'], samples_per_label=1, seed=3)
        outs.append((rows, js, merged, sampled))
    assert outs[1] == outs[0]
    assert outs[0][1]['images']['ds1/loc1/gt.jpg']['detections'][0][
        'conf'] == 1.0


def test_merge_cli_identical(merge_world, tmp_path, monkeypatch, capsys):
    def run(side, out):
        monkeypatch.setattr(sys, 'argv', [
            'merge_classification_detection_output', merge_world['outputs'],
            merge_world['detections'], os.path.join(out, 'm.json'),
            '--label_index', merge_world['index'], '--threshold', '0.1',
            '--top_k', '2', '--label_first', '--classifier_name', 'x'])
        MERGE[side].main()
        return cd.relative(capsys.readouterr().out, out)

    (ours, got), (ref, want) = cd.both(tmp_path, 'cli', run)
    assert ours == ref
    cd.assert_same_tree(got, want, ('classification_completion_time',))


#%% identify_mislabeled_candidates, save_mislabeled


@pytest.mark.parametrize('margin,with_dataset', [
    (0.5, False), (0.1, True), (0.0, False), (0.95, False)])
def test_identify_mislabeled_candidates_identical(merge_world, tmp_path,
                                                  margin, with_dataset,
                                                  capsys):
    def run(side, out):
        value = MISLABELED[side].identify_mislabeled_candidates(
            merge_world['outputs'], 'val', out, margin=margin,
            include_dataset_in_filename=with_dataset)
        return value, capsys.readouterr().out

    (ours, got), (ref, want) = cd.both(tmp_path, 'mislabeled', run)
    assert ours == ref
    assert list(ours[0]) == list(ref[0])
    if ours[0]:
        cd.assert_same_tree(got, want)
    frames = [m.get_candidates_df(merge_world['outputs'], LABELS, margin)
              for m in MISLABELED]
    import pandas as pd
    pd.testing.assert_frame_equal(frames[1], frames[0])
    if margin > 0:
        # at margin 0 the frame also holds the rows predicted right
        assert len(frames[0]) == sum(len(v) for v in ours[0].values())


def test_identify_mislabeled_candidates_cli_identical(merge_world, tmp_path,
                                                      monkeypatch, capsys):
    def run(side, out):
        monkeypatch.setattr(sys, 'argv', [
            'identify_mislabeled_candidates', merge_world['outputs'],
            '--split', 'test', '--logdir', out, '--margin', '0.2',
            '--include_dataset_in_filename'])
        MISLABELED[side].main()
        return capsys.readouterr().out

    (ours, got), (ref, want) = cd.both(tmp_path, 'cli', run)
    assert ours == ref
    cd.assert_same_tree(got, want)


def _ledger_rows(path):
    """The ledger's rows with their timestamps blanked."""

    with open(path, newline='') as f:
        return [dict(r, timestamp='') for r in csv.DictReader(f)]


def test_save_mislabeled_ledger_and_filter_identical(tmp_path, capsys):
    queried = {'ds1/a.jpg': {'dataset': 'ds1', 'class': 'deer'},
               'ds1/c.jpg': {'dataset': 'ds1', 'class': 'deer'},
               'ds2/x/b.jpg': {'dataset': 'ds2', 'class': 'elk'}}
    queried_path = str(tmp_path / 'queried.json')
    with open(queried_path, 'w') as f:
        json.dump(queried, f)

    def run(side, out):
        ledger = os.path.join(out, 'sub', 'ledger.csv')
        first = SAVE[side].save_mislabeled(ledger, [
            {'dataset': 'ds1', 'file': 'ds1/a.jpg', 'original_label': 'deer',
             'corrected_label': 'elk', 'extra': 'dropped'},
            {'dataset': 'ds2', 'file': 'x/b.jpg', 'note': 'blurry'}])
        second = SAVE[side].save_mislabeled(ledger, [
            {'dataset': 'ds1', 'file': 'ds1/a.jpg',
             'corrected_label': 'wolf'}])
        kept = SAVE[side].filter_queried_images(
            queried_path, ledger, os.path.join(out, 'filtered.json'))
        rows = _ledger_rows(ledger)
        os.remove(ledger)
        return ([sorted(first), sorted(second)], kept, rows,
                capsys.readouterr().out)

    (ours, got), (ref, want) = cd.both(tmp_path, 'ledger', run)
    assert ours == ref
    assert list(ours[1]) == ['ds1/c.jpg']
    assert ours[2][0]['corrected_label'] == 'wolf'
    cd.assert_same_tree(got, want)
    with pytest.raises(AssertionError):
        SAVE[1].save_mislabeled(str(tmp_path / 'l.csv'), [{'note': 'x'}])
    assert SAVE[1].read_ledger(str(tmp_path / 'absent.csv')) == {}


def test_update_mislabeled_images_identical(tmp_path, capsys):
    review = str(tmp_path / 'review.csv')
    with open(review, 'w') as f:
        f.write('RelativePath,File,mislabeled,correct_class\n'
                'ds1\\cam1,im1.jpg,True,elk\n'
                'ds1\\cam1,im2.jpg,False,\n'
                'ds1\\cam2,im4.jpg,yes,wolf\n'
                'ds2\\cam9,im3.jpg,1,\n')

    def run(side, out):
        SAVE[side].update_mislabeled_images(out, review)
        # a second review: the same file again, corrected anew
        with open(os.path.join(out, 'again.csv'), 'w') as f:
            f.write('RelativePath,File,mislabeled,correct_class\n'
                    'ds1\\cam1,im1.jpg,TRUE,moose\n')
        SAVE[side].update_mislabeled_images(out,
                                            os.path.join(out, 'again.csv'))
        return capsys.readouterr().out

    (ours, got), (ref, want) = cd.both(tmp_path, 'update', run)
    assert ours == ref
    cd.assert_same_tree(got, want)
    with open(os.path.join(got, 'megadb_mislabeled', 'ds1.csv')) as f:
        assert 'cam1/im1.jpg,moose' in f.read()
    bad = str(tmp_path / 'bad.csv')
    with open(bad, 'w') as f:
        f.write('RelativePath,File,mislabeled,correct_class\n'
                'ds1\\cam1,im1.jpg,False,elk\n')
    messages = []
    for module in SAVE:
        with pytest.raises(AssertionError) as info:
            module.update_mislabeled_images(str(tmp_path), bad)
        messages.append(str(info.value))
    assert messages[1] == messages[0]


@pytest.mark.parametrize('command', ['add', 'filter'])
def test_save_mislabeled_cli_identical(tmp_path, monkeypatch, command,
                                       capsys):
    queried_path = str(tmp_path / 'queried.json')
    with open(queried_path, 'w') as f:
        json.dump({'ds1/a.jpg': {}, 'ds1/b.jpg': {}}, f)

    def run(side, out):
        ledger = os.path.join(out, 'ledger.csv')
        SAVE[side].save_mislabeled(ledger, [{'dataset': 'ds1',
                                             'file': 'a.jpg'}])
        argv = ['save_mislabeled', 'add', ledger, '--dataset', 'ds1',
                '--file', 'b.jpg', '--note', 'n'] if command == 'add' else \
            ['save_mislabeled', 'filter', ledger, queried_path,
             os.path.join(out, 'f.json')]
        monkeypatch.setattr(sys, 'argv', argv)
        SAVE[side].main()
        rows = _ledger_rows(ledger)
        os.remove(ledger)
        return rows, capsys.readouterr().out

    (ours, got), (ref, want) = cd.both(tmp_path, 'cli', run)
    assert ours == ref
    if command == 'filter':
        cd.assert_same_tree(got, want)


#%% analyze_failed_images


@pytest.fixture(scope='module')
def failed_world(tmp_path_factory):
    root = tmp_path_factory.mktemp('failed_images')
    rng = np.random.RandomState(2)
    good = root / 'good.jpg'
    Image.fromarray(rng.randint(0, 256, (40, 48, 3), np.uint8)).save(
        str(good))
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (20, 24, 3), np.uint8)).save(
            str(root / 'ok_{}.jpg'.format(i)))
    data = good.read_bytes()
    (root / 'empty.jpg').write_bytes(b'')
    (root / 'garbage.jpg').write_bytes(b'not an image at all')
    (root / 'head.jpg').write_bytes(data[:40])
    (root / 'half.jpg').write_bytes(data[:len(data) // 2])
    (root / 'notes.txt').write_text('text')
    names = ['good.jpg', 'ok_0.jpg', 'empty.jpg', 'garbage.jpg', 'head.jpg',
             'half.jpg', 'missing.jpg', 'ok_1.jpg', 'ok_2.jpg']
    return str(root), names


@pytest.mark.parametrize('threads,truncated_flag', [(1, True), (4, False)])
def test_analyze_failed_images_identical(failed_world, tmp_path, threads,
                                         truncated_flag, monkeypatch,
                                         capsys):
    """Every status, in threads; PIL's process-wide truncated-image flag
    is set and restored by each diagnosis, as the JAX module does (set to
    True only on one thread: threads that save and restore it race, in
    both packages)."""

    folder, names = failed_world
    monkeypatch.setattr(ImageFile, 'LOAD_TRUNCATED_IMAGES', truncated_flag)
    before = ImageFile.LOAD_TRUNCATED_IMAGES

    def run(side, out):
        value = FAILED[side].analyze_failed_images(
            names, folder, os.path.join(out, 'report.json'),
            threads=threads)
        return value, cd.relative(capsys.readouterr().out, out)

    (ours, got), (ref, want) = cd.both(tmp_path, 'failed', run)
    assert ours == ref
    cd.assert_same_tree(got, want)
    assert ImageFile.LOAD_TRUNCATED_IMAGES == before
    by = ours[0]['by_status']
    assert [e['file'] for e in by['truncated']] == ['head.jpg', 'half.jpg']
    assert sorted(e['file'] for e in by['ok']) == \
        ['good.jpg', 'ok_0.jpg', 'ok_1.jpg', 'ok_2.jpg']


def test_check_image_condition_and_analyze_images_identical(
        failed_world, tmp_path, capsys):
    folder, names = failed_world
    paths = [os.path.join(folder, n) for n in names + ['notes.txt']]
    outs = []
    for module in FAILED:
        conditions = [module.check_image_condition(p) for p in paths]
        with pytest.raises(AssertionError) as info:
            module.check_image_condition(paths[0], account='acct')
        listing = str(tmp_path / 'paths.txt')
        with open(listing, 'w') as f:
            f.write('\n'.join(paths) + '\n\n')
        keyed = str(tmp_path / 'paths.json')
        with open(keyed, 'w') as f:
            json.dump({'failed': paths[2:6], 'other': paths[:2]}, f)
        plain = str(tmp_path / 'plain.json')
        with open(plain, 'w') as f:
            json.dump(paths[:3], f)
        reports = [module.analyze_images(listing, threads=2),
                   module.analyze_images(keyed, json_keys=['failed']),
                   module.analyze_images(plain)]
        outs.append((conditions, str(info.value), reports,
                     capsys.readouterr().out))
    assert outs[1] == outs[0]
    assert [c[1] for c in outs[0][0]] == [
        'good', 'good', 'bad', 'bad', 'bad', 'truncated', 'nonexistent',
        'good', 'good', 'non_image']


@pytest.mark.parametrize('source', ['txt', 'failed_images', 'md'])
def test_analyze_failed_images_cli_identical(failed_world, tmp_path,
                                             monkeypatch, source, capsys):
    folder, names = failed_world
    if source == 'txt':
        listing = str(tmp_path / 'failed.txt')
        with open(listing, 'w') as f:
            f.write('\n'.join(names))
    else:
        listing = str(tmp_path / 'failed.json')
        data = {'failed_images': names} if source == 'failed_images' else \
            {'images': [{'file': n, 'failure': 'x' if i % 2 else None}
                        for i, n in enumerate(names)]}
        with open(listing, 'w') as f:
            json.dump(data, f)

    def run(side, out):
        monkeypatch.setattr(sys, 'argv', [
            'analyze_failed_images', listing, '--images_dir', folder,
            '--output_json', os.path.join(out, 'r.json'), '--threads', '3'])
        FAILED[side].main()
        return cd.relative(capsys.readouterr().out, out)

    (ours, got), (ref, want) = cd.both(tmp_path, 'cli', run)
    assert ours == ref
    cd.assert_same_tree(got, want)
