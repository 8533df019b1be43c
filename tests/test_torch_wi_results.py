"""
The port's Wildlife Insights and SpeciesNet results layer against the JAX
package's, on the same inputs, bytes written and values returned:
utils/wi_utils (taxonomy strings, the prediction predicates,
wi_predictions_to_md), utils/wi_taxonomy_utils (the prediction-string
helpers, predictions.json <-> MD results, instances, batches and merges,
validation, geofence adjustments and their HTML, whole-image detections,
TaxonomyHandler with its geofencing queries and CSV export),
data_management/speciesnet_to_md (its CLI),
taxonomy_mapping/map_lila_taxonomy_to_wi_taxonomy,
utils/split_locations_into_train_val and utils/directory_listing; the
public signatures of the nine modules of the slice. Mirrors
tests/test_wi_utils.py, tests/test_geofencing.py, the WI, split and
directory tests of tests/test_ecosystem_tools.py,
tests/test_uncovered_modules.py's speciesnet_to_md CLI and
tests/test_taxonomy_tools.py's map_lila_taxonomy_to_wi. Inputs come from
tests/torch_wi_data.py.
"""

import ast
import copy
import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_wi_data as wd  # noqa: E402
from torch_cct_data import pair  # noqa: E402
from torch_format_data import read, run_main  # noqa: E402
from torch_postprocessing_data import both  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WI_UTILS = pair('utils.wi_utils')
WTU = pair('utils.wi_taxonomy_utils')
SN_TO_MD = pair('data_management.speciesnet_to_md')
LILA_TO_WI = pair('taxonomy_mapping.map_lila_taxonomy_to_wi_taxonomy')
SPLIT = pair('utils.split_locations_into_train_val')
LISTING = pair('utils.directory_listing')

DEER7 = 'uuid-1;mammalia;cetartiodactyla;cervidae;odocoileus;' \
    'virginianus;white-tailed deer'
STRINGS = [DEER7, wd.BLANK, wd.HUMAN, wd.VEHICLE, wd.NO_CV,
           '1f689929-883d-4dae-958c-3d57ab5b6c16;;;;;;animal',
           'u2;mammalia;carnivora;canidae;;;canine family',
           'u3;aves;;;;;bird', 'u4;mammalia;primates;hominidae;homo;;'
           'homo species', 'u5;;;;;;person'] + wd.TAXONOMY_LINES[:7]


#%% wi_utils (tests/test_wi_utils.py)


@pytest.mark.parametrize('s', STRINGS)
def test_wi_utils_strings_match(s):
    jax, port = WI_UTILS
    for name in ('parse_taxonomy_string', 'taxonomy_string_to_binomial_name',
                 'taxonomy_string_to_common_name', 'is_blank_prediction',
                 'is_human_prediction', 'is_animal_prediction'):
        assert getattr(port, name)(s) == getattr(jax, name)(s), name
    fields = port.parse_taxonomy_string(s)
    assert port.build_taxonomy_string(
        fields['guid'], fields['class'], fields['order'], fields['family'],
        fields['genus'], fields['species'], fields['common_name']) == s
    for name in ('TAXONOMY_STRING_FIELDS', 'BLANK_GUID', 'ANIMAL_GUID',
                 'HUMAN_GUID', 'VEHICLE_GUID', 'NO_CV_RESULT_GUID'):
        assert getattr(port, name) == getattr(jax, name)


def test_wi_utils_reference_cases():
    _, port = WI_UTILS
    assert port.taxonomy_string_to_binomial_name(DEER7) == \
        'Odocoileus virginianus'
    assert port.taxonomy_string_to_common_name(DEER7) == 'white-tailed deer'
    assert port.is_blank_prediction(port.BLANK_GUID + ';;;;;;blank')
    assert port.is_animal_prediction(DEER7)
    assert not port.is_animal_prediction(wd.HUMAN)
    with pytest.raises(AssertionError):
        port.parse_taxonomy_string('a;b;c')


@pytest.mark.parametrize('base_confidence', [None, 0.3])
def test_wi_predictions_to_md_matches(tmp_path, base_confidence):
    predictions = wd.ensemble_predictions(seed=1)
    # Filenames, labels a person and an unknown, a prediction without a
    # score
    predictions['predictions'][0]['filename'] = \
        predictions['predictions'][0].pop('filepath')
    predictions['predictions'][1]['detections'] = [
        {'label': 'person', 'conf': 0.7, 'bbox': [0.1, 0.1, 0.2, 0.2]},
        {'conf': 0.5, 'bbox': [0.3, 0.3, 0.2, 0.2]}]
    predictions['predictions'][2].pop('prediction_score')
    predictions['predictions'][3]['prediction'] = DEER7
    predictions['predictions'][3]['detections'] = []

    def run(side, folder):
        out = os.path.join(folder, 'md.json')
        value = WI_UTILS[side].wi_predictions_to_md(
            copy.deepcopy(predictions), output_file=out,
            base_confidence=base_confidence)
        return value, read(out)

    (ours, _), (ref, _) = both(tmp_path, 'wi_to_md', run)
    assert ours == ref
    assert 'classification_categories' in ours[0]
    path = str(tmp_path / 'predictions.json')
    with open(path, 'w') as f:
        json.dump(predictions, f)
    assert WI_UTILS[1].wi_predictions_to_md(path) == \
        WI_UTILS[0].wi_predictions_to_md(path)
    by_file = {im['file']: im for im in ours[0]['images']}
    assert by_file['/data/images/cam1/img_005.jpg']['detections'] is None


#%% wi_taxonomy_utils' strings (tests/test_ecosystem_tools.py)


@pytest.mark.parametrize('s', STRINGS + ['mammalia;carnivora;canidae;;;x'])
def test_prediction_string_helpers_match(s):
    jax, port = WTU
    for name in ('is_valid_prediction_string', 'is_valid_taxonomy_string',
                 'is_valid_geofence_taxonomy_string', 'clean_taxonomy_string',
                 'taxonomy_level_index', 'is_taxonomic_prediction_string',
                 'get_kingdom', 'is_human_classification',
                 'is_vehicle_classification', 'is_animal_classification'):
        assert getattr(port, name)(s) == getattr(jax, name)(s), name
    if s.count(';') == 6:
        assert port.get_common_name_from_prediction_string(s) == \
            jax.get_common_name_from_prediction_string(s)


def test_taxonomy_level_and_info_helpers_match():
    jax, port = WTU
    for k in range(5):
        assert port.taxonomy_level_to_string(k) == \
            jax.taxonomy_level_to_string(k)
        name = jax.taxonomy_level_to_string(k)
        assert port.taxonomy_level_string_to_index(name.upper()) == k
    for k in (-1, 5):
        with pytest.raises(ValueError):
            port.taxonomy_level_to_string(k)
    info = {'class': 'Mammalia', 'order': 'Carnivora', 'family': None,
            'genus': 'Vulpes', 'species': 'vulpes', 'taxon_id': 'T1',
            'common_name': 'Red Fox'}
    for flag in (False, True):
        assert port.taxonomy_info_to_taxonomy_string(info, flag) == \
            jax.taxonomy_info_to_taxonomy_string(info, flag)
    for name in ('TAXONOMY_LEVELS', 'blank_prediction_string',
                 'no_cv_result_prediction_string',
                 'animal_prediction_string', 'human_prediction_string',
                 'vehicle_prediction_string', 'current_format_version'):
        assert getattr(port, name) == getattr(jax, name)
    s = 'u1;mammalia;carnivora;canidae;vulpes;vulpes;red fox'
    assert port.clean_taxonomy_string(s) == \
        'mammalia;carnivora;canidae;vulpes;vulpes;red fox'
    assert port.taxonomy_level_index(s) == 4
    assert not port.is_taxonomic_prediction_string(
        port.blank_prediction_string)


#%% predictions.json <-> MD results


@pytest.mark.parametrize('options', [
    {}, {'base_folder': '/data/images'}, {'base_folder': '/data/images/'},
    {'base_folder': '/elsewhere'},
    {'convert_human_to_person': False,
     'convert_homo_species_to_human': False, 'verbose': True}])
def test_md_results_from_predictions_match(tmp_path, options):
    predictions = wd.ensemble_predictions(seed=2)
    predictions['predictions'][3]['prediction'] = \
        'u4;mammalia;primates;hominidae;homo;;homo species'

    def run(side, folder):
        out = os.path.join(folder, 'md.json')
        value = WTU[side].generate_md_results_from_predictions_json(
            copy.deepcopy(predictions), md_results_file=out, **options)
        return value, read(out)

    (ours, _), (ref, _) = both(tmp_path, 'to_md', run)
    assert ours == ref
    md = ours[0]
    assert 'unknown' in md['detection_categories'].values()
    # From a file too, no output file
    path = str(tmp_path / 'predictions.json')
    with open(path, 'w') as f:
        json.dump(predictions, f)
    assert WTU[1].generate_md_results_from_predictions_json(path) == \
        WTU[0].generate_md_results_from_predictions_json(path)


def test_predictions_json_round_trip_matches(tmp_path):
    """tests/test_ecosystem_tools.py's round trip through both packages."""

    predictions = {'predictions': [
        {'filepath': '/data/images/a.jpg',
         'detections': [{'category': '1', 'label': 'animal',
                         'conf': 0.9, 'bbox': [0.1, 0.1, 0.4, 0.4]}],
         'classifications': {
             'classes': ['u1;mammalia;carnivora;canidae;vulpes;'
                         'vulpes;red fox'],
             'scores': [0.8]},
         'prediction': 'u1;mammalia;carnivora;canidae;vulpes;vulpes;'
                       'red fox',
         'prediction_score': 0.8},
        {'filepath': '/data/images/b.jpg',
         'detections': [],
         'prediction': 'u9;mammalia;cetartiodactyla;cervidae;;;'
                       'deer family',
         'prediction_score': 0.55},
        {'filepath': '/data/images/c.jpg',
         'failures': ['DETECTOR']},
    ]}

    def run(side, folder):
        w = WTU[side]
        md_file = os.path.join(folder, 'md.json')
        md = w.generate_md_results_from_predictions_json(
            copy.deepcopy(predictions), md_results_file=md_file,
            base_folder='/data/images')
        back_file = os.path.join(folder, 'back.json')
        back = w.generate_predictions_json_from_md_results(
            md_file, predictions_json_file=back_file,
            base_folder='/data/images')
        in_memory = w.generate_predictions_json_from_md_results(md)
        return md, back, in_memory, read(md_file), read(back_file)

    (ours, _), (ref, _) = both(tmp_path, 'round_trip', run)
    assert ours == ref
    md = ours[0]
    assert [im['file'] for im in md['images']] == ['a.jpg', 'b.jpg', 'c.jpg']
    a, b, c = md['images']
    assert a['detections'][0]['classifications'][0][1] == 0.8
    assert b['detections'][0]['bbox'] == [0, 0, 1, 1]
    assert c['detections'] is None and 'failure' in c
    assert [p['filepath'] for p in ours[1]['predictions']] == \
        ['/data/images/a.jpg', '/data/images/b.jpg', '/data/images/c.jpg']


def test_instances_batches_merge_and_validation_match(tmp_path):
    rng = np.random.RandomState(3)
    folder = tmp_path / 'images'
    for i in range(7):
        sub = folder / 'cam{}'.format(i % 2)
        sub.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (8, 8, 3), np.uint8)).save(
            str(sub / 'img_{:03d}.jpg'.format(i)))
    (folder / 'notes.txt').write_text('x')
    predictions = wd.ensemble_predictions(n=7, seed=3, base=str(folder))

    def run(side, out):
        w = WTU[side]
        values = []
        for kwargs in ({}, {'country': 'USA', 'admin1_region': 'CA'},
                       {'recursive': False}):
            values.append(w.generate_instances_json_from_folder(
                str(folder), **kwargs))
        inst_file = os.path.join(out, 'instances.json')
        w.generate_instances_json_from_folder(str(folder), country='CAN',
                                              output_file=inst_file)
        batches = w.split_instances_into_n_batches(inst_file, 3)
        named = w.split_instances_into_n_batches(
            values[0], 2, output_files=[os.path.join(out, 'b0.json'),
                                        os.path.join(out, 'b1.json')])
        shards = []
        for i, names in enumerate((slice(0, 3), slice(3, 7))):
            fn = os.path.join(out, 'p{}.json'.format(i))
            with open(fn, 'w') as f:
                json.dump({'predictions': predictions['predictions'][names]},
                          f)
            shards.append(fn)
        merged_file = os.path.join(out, 'merged.json')
        merged = w.merge_prediction_json_files(shards, merged_file)
        validated = w.validate_predictions_file(merged_file, inst_file)
        loaded = [w.load_md_or_speciesnet_file(fn, verbose=True)
                  for fn in (merged_file,)]
        md_file = os.path.join(out, 'md.json')
        w.generate_md_results_from_predictions_json(merged, md_file)
        loaded.append(w.load_md_or_speciesnet_file(md_file))
        return (values, [read(fn) for fn in batches + named],
                [os.path.basename(fn) for fn in batches + named],
                merged, read(merged_file), validated, loaded)

    (ours, out_p), (ref, out_j) = both(tmp_path, 'instances', run)
    assert ours[1:] == ref[1:]
    assert ours[0] == ref[0]
    assert len(ours[0][0]['instances']) == 7
    assert len(ours[0][2]['instances']) == 0
    assert ours[2][:3] == ['instances_batch_000.json',
                           'instances_batch_001.json',
                           'instances_batch_002.json']
    _, port = WTU
    # Duplicates, unsorted scores, missing instances
    with pytest.raises(AssertionError):
        port.merge_prediction_json_files(
            [os.path.join(out_p, 'p0.json')] * 2)
    bad = copy.deepcopy(predictions)
    bad['predictions'][0]['classifications']['scores'].reverse()
    bad_file = str(tmp_path / 'bad.json')
    with open(bad_file, 'w') as f:
        json.dump(bad, f)
    for side in (0, 1):
        with pytest.raises(AssertionError):
            WTU[side].validate_predictions_file(bad_file)
        with pytest.raises(AssertionError):
            WTU[side].validate_predictions_file(
                os.path.join(out_p, 'p0.json'),
                os.path.join(out_p, 'instances.json'))


@pytest.mark.parametrize('use_latin_names', [False, True])
def test_geofence_adjustments_and_html_match(tmp_path, use_latin_names):
    predictions = wd.ensemble_predictions(n=60, seed=4)
    path = str(tmp_path / 'ensemble.json')
    with open(path, 'w') as f:
        json.dump(predictions, f)
    jax, port = WTU
    ours = port.find_geofence_adjustments(path, use_latin_names)
    assert ours == jax.find_geofence_adjustments(predictions,
                                                 use_latin_names)
    assert list(ours) == list(jax.find_geofence_adjustments(
        path, use_latin_names))
    assert sum(ours.values()) > 5
    for min_count in (1, 2, 3, 100):
        assert port.generate_geofence_adjustment_html_summary(
            ours, min_count) == jax.generate_geofence_adjustment_html_summary(
                ours, min_count)
    pairs = {'puma,felidae': 20, 'deer,cervidae': 12, 'rare,thing': 2}
    html = port.generate_geofence_adjustment_html_summary(pairs, 10)
    assert 'puma &rarr; felidae (20)' in html and 'rare' not in html
    assert port.generate_geofence_adjustment_html_summary({}, 10) == ''
    with pytest.raises(AssertionError):
        port.generate_geofence_adjustment_html_summary({'a': 1, 'b': 2}, 1)


@pytest.mark.parametrize('ignore_blank', [True, False])
def test_whole_image_detections_match(tmp_path, ignore_blank):
    """tests/test_geofencing.py's whole-image detections, through both."""

    preds = {'predictions': [
        {'filepath': 'a.jpg',
         'classifications': {'classes': [wd.TAXONOMY_LINES[1]],
                             'scores': [0.9]}},
        {'filepath': 'b.jpg',
         'classifications': {'classes': [wd.BLANK, wd.HUMAN],
                             'scores': [0.8, 0.6]}},
        {'filepath': 'c.jpg',
         'classifications': {'classes': [wd.NO_CV, wd.BLANK],
                             'scores': [0.7, 0.2]}},
        {'filepath': 'd.jpg',
         'classifications': {'classes': [wd.VEHICLE, wd.BLANK],
                             'scores': [0.6, 0.3]}},
    ]}
    cls_file = str(tmp_path / 'cls.json')
    with open(cls_file, 'w') as f:
        json.dump(preds, f)

    def run(side, folder):
        det_file = os.path.join(folder, 'det.json')
        ens_file = os.path.join(folder, 'ens.json')
        value = WTU[side].generate_whole_image_detections_for_classifications(
            cls_file, det_file, ensemble_json_file=ens_file,
            ignore_blank_classifications=ignore_blank)
        in_memory = \
            WTU[side].generate_whole_image_detections_for_classifications(
                copy.deepcopy(preds), os.path.join(folder, 'det2.json'),
                verbose=False)
        return value, in_memory, read(det_file), read(ens_file)

    (ours, _), (ref, _) = both(tmp_path, 'whole_image', run)
    assert ours == ref
    d = json.loads(ours[2])
    det_b = d['predictions'][1]['detections'][0]
    if ignore_blank:
        assert det_b['label'] == 'human' and det_b['category'] == '2'
    assert d['predictions'][0]['detections'][0]['bbox'] == [0, 0, 1, 1]


#%% TaxonomyHandler and geofencing (tests/test_geofencing.py)


@pytest.fixture(scope='module')
def handlers(tmp_path_factory):
    geofence_file, cc_file = wd.geofence_files(
        tmp_path_factory.mktemp('geofence'))
    return tuple(m.TaxonomyHandler(wd.TAXONOMY_LINES,
                                   geofencing_file=geofence_file,
                                   country_code_file=cc_file) for m in WTU)


def test_handler_tables_match(handlers, tmp_path):
    ref, ours = handlers
    for name in ('prediction_strings', 'common_name_to_string',
                 'latin_name_to_string', 'taxonomy_string_to_taxonomy_info',
                 'binomial_name_to_taxonomy_info',
                 'common_name_to_taxonomy_info',
                 'taxonomy_string_to_geofencing_rules',
                 'country_to_country_code', 'country_code_to_country'):
        assert getattr(ours, name) == getattr(ref, name), name
    # From a file, without geofencing
    path = str(tmp_path / 'taxonomy.txt')
    with open(path, 'w') as f:
        f.write('\n'.join(wd.TAXONOMY_LINES + ['', 'not;a;string']) + '\n')
    jax, port = WTU
    assert vars(port.TaxonomyHandler(path)) == vars(jax.TaxonomyHandler(path))
    with pytest.raises(AssertionError):
        port.TaxonomyHandler(wd.TAXONOMY_LINES, geofencing_file=path)


NAMES = ['puma', 'puma concolor', 'white-tailed deer', 'canis lupus dingo',
         'dingo', 'rodent', 'rodentia', 'red fox', 'vulpes vulpes', 'bird',
         'aves', 'human', 'homo sapiens', 'canine family', 'canidae',
         wd.PUMA, wd.TAXONOMY_LINES[1], 'unobtainium', 'Puma ']


@pytest.mark.parametrize('name', NAMES)
def test_handler_lookups_match(handlers, name):
    ref, ours = handlers

    def call(handler, method, *args):
        try:
            return 'value', getattr(handler, method)(*args)
        except (ValueError, AssertionError) as e:
            return type(e).__name__, str(e)

    for method in ('string_for_name',
                   'species_string_to_canonical_species_string',
                   'species_string_to_taxonomy_info'):
        assert call(ours, method, name) == call(ref, method, name), method
    s = ours.string_for_name(name)
    if s is not None:
        assert ours.parent_string(s) == ref.parent_string(s)
        assert ours.ancestor_chain(s) == ref.ancestor_chain(s)


def test_handler_reference_cases(handlers):
    _, handler = handlers
    info = handler.species_string_to_taxonomy_info('puma')
    assert info['genus'] == 'puma' and info['species'] == 'concolor'
    info = handler.species_string_to_taxonomy_info('canis lupus dingo')
    assert info['common_name'] == 'dingo'
    with pytest.raises(ValueError):
        handler.species_string_to_taxonomy_info('unobtainium')
    s = handler.string_for_name('red fox')
    assert handler.string_for_name('vulpes vulpes') == s
    assert len(handler.ancestor_chain(s)) == 4


@pytest.mark.parametrize('country', ['USA', 'usa', 'Canada', 'AUS',
                                     'argentina', 'ARG'])
@pytest.mark.parametrize('state', [None, 'AL', 'ny', 'HI'])
def test_species_allowed_in_country_matches(handlers, country, state):
    ref, ours = handlers
    for species in ('white-tailed deer', 'puma', 'dingo', 'rodent',
                    'red fox', wd.DEER, 'canis lupus dingo'):
        for status in (False, True):
            assert ours.species_allowed_in_country(
                species, country, state=state, return_status=status) == \
                ref.species_allowed_in_country(
                    species, country, state=state, return_status=status)
    assert ours.find_taxa_allowed_in_region(country, state=state) == \
        ref.find_taxa_allowed_in_region(country, state=state)


def test_geofencing_reference_cases(handlers):
    _, handler = handlers
    assert handler.species_allowed_in_country(
        'white-tailed deer', 'AUS', return_status=True) == \
        'block_not_on_country_allow_list'
    assert handler.species_allowed_in_country(
        'puma', 'ARG', return_status=True) == 'allow_not_on_block_list'
    assert handler.species_allowed_in_country(
        'rodent', 'AUS', return_status=True) == 'allow_by_default'
    assert handler.species_allowed_in_country(
        'white-tailed deer', 'USA', state='AL',
        return_status=True) == 'allow_by_state'
    assert handler.species_allowed_in_country(
        'white-tailed deer', 'USA', state='NY',
        return_status=True) == 'block_other_states_allowed'
    assert handler.species_allowed_in_country(
        'dingo', 'USA', return_status=True) == 'block_usa_wide'
    with pytest.raises(AssertionError):
        handler.species_allowed_in_country('puma', 'Atlantis')


def test_geofence_rows_match(handlers):
    ref, ours = handlers
    for kwargs in ({'allow_countries': 'arg, can', 'block_states': ['NY']},
                   {'block_countries': ['aus', 'usa'],
                    'allow_states': 'AL,AZ'}, {}):
        assert ours.generate_csv_rows_for_species(wd.PUMA, **kwargs) == \
            ref.generate_csv_rows_for_species(wd.PUMA, **kwargs)
    rows = ours.generate_csv_rows_for_species(
        wd.PUMA, allow_countries='arg, can', block_states=['NY'])
    assert rows == [wd.PUMA + ',allow,ARG,', wd.PUMA + ',allow,CAN,',
                    wd.PUMA + ',block,USA,NY']
    def block_except(handler, species, keep):
        try:
            return handler.generate_csv_rows_to_block_all_countries_except(
                species, keep)
        except ValueError as e:
            return str(e)

    for species, keep in ((wd.DEER, ['CAN', 'ARG']), (wd.DEER, 'can'),
                          (wd.FOX, ['ARG']), (wd.DINGO, ['USA']),
                          (wd.DINGO, ['CAN'])):
        assert block_except(ours, species, keep) == \
            block_except(ref, species, keep)
    rows = ours.generate_csv_rows_to_block_all_countries_except(
        wd.DEER, ['CAN', 'ARG'])
    assert wd.DEER + ',block,USA,' in rows and wd.DEER + ',allow,ARG,' in rows
    with pytest.raises(ValueError):
        ours.generate_csv_rows_to_block_all_countries_except(wd.DINGO,
                                                             ['USA'])
    with pytest.raises(AssertionError):
        ours.generate_csv_rows_for_species('not a taxonomy string')


@pytest.mark.parametrize('include_common_names', [True, False])
def test_export_geofence_csv_matches(handlers, tmp_path,
                                     include_common_names):
    ref, ours = handlers

    def run(side, folder):
        csv_fn = os.path.join(folder, 'geofence_export.csv')
        df = handlers[side].export_geofence_data_to_csv(
            csv_fn, include_common_names=include_common_names)
        return df.to_dict(), list(df.columns), read(csv_fn)

    (got, _), (want, _) = both(tmp_path, 'export', run)
    assert got[1:] == want[1:]
    assert str(got[0]) == str(want[0])
    df = ours.export_geofence_data_to_csv()
    assert df.loc[wd.DEER, 'USA:AL'] == 1
    assert ('common_name' in df.columns) is True


#%% speciesnet_to_md (tests/test_uncovered_modules.py)


def test_speciesnet_to_md_cli_matches(tmp_path, monkeypatch, capsys):
    predictions = wd.ensemble_predictions(seed=5, base='base')
    pred_file = str(tmp_path / 'predictions.json')
    with open(pred_file, 'w') as f:
        json.dump(predictions, f)
    outs = []
    for side, module in enumerate(SN_TO_MD):
        out = str(tmp_path / 'md{}.json'.format(side))
        run_main(module, ['speciesnet_to_md', pred_file, out,
                          '--base_folder', 'base/'], monkeypatch)
        outs.append(read(out))
    assert outs[0] == outs[1]
    md = json.loads(outs[1])
    assert md['images'][0]['file'].startswith('cam0/')
    # The port's CLI as its own process; and its help with no arguments
    out = str(tmp_path / 'md_process.json')
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    result = subprocess.run(
        [sys.executable, '-m',
         'megadetector_tpu_torch.data_management.speciesnet_to_md',
         pred_file, out, '--base_folder', 'base/'], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-500:]
    assert read(out) == outs[0]
    helps = []
    for module in SN_TO_MD:
        with pytest.raises(SystemExit):
            run_main(module, ['speciesnet_to_md'], monkeypatch)
        helps.append(capsys.readouterr().out)
    assert helps[0] == helps[1] and 'usage:' in helps[0]


#%% map_lila_taxonomy_to_wi (tests/test_taxonomy_tools.py)


WI_TAXONOMY = [
    'uuid1;mammalia;carnivora;felidae;puma;concolor;cougar',
    'uuid2;mammalia;carnivora;felidae;;;cat family',
    'uuid3;mammalia;rodentia;sciuridae;;;squirrel family',
    'uuid4;mammalia;;;;;mammal',
    'uuid5;aves;;;;;bird',
]

GOOD_ANCESTRY = [(1, 'species', 'puma concolor', ['cougar']),
                 (2, 'genus', 'puma', []), (3, 'family', 'felidae', [])]


def _lila_rows():
    def row(ds, query, level, name, ancestry):
        return {'dataset_name': ds, 'query': query, 'taxonomy_level': level,
                'scientific_name': name,
                'taxonomy_string': repr(ancestry) if ancestry else ''}

    return [
        row('ds1', 'cougar', 'species', 'puma concolor', GOOD_ANCESTRY),
        row('ds1', 'flying squirrel', 'tribe', 'pteromyini',
            [(1, 'tribe', 'pteromyini', []), (2, 'family', 'sciuridae', []),
             (3, 'order', 'rodentia', [])]),
        row('ds1', 'weird', 'species', 'mysterius beastus',
            [(9, 'species', 'mysterius beastus', [])]),
        row('ds1', 'fog', '', '', None),
        row('ds2', 'lynx', 'species', 'lynx rufus',
            [(4, 'species', 'lynx rufus', []), (5, 'genus', 'lynx', []),
             (3, 'family', 'felidae', [])]),
        row('ds2', 'grouse', 'species', 'mystery grouse',
            [(6, 'species', 'mystery grouse', []),
             (7, 'family', 'grousidae', []), (8, 'class', 'aves', [])]),
        row('ds2', 'cat', 'family', 'cat family', None),
        row('ds2', 'broken', 'species', 'x', None),
    ]


@pytest.mark.parametrize('supplementary', ['dict', 'csv', None])
def test_map_lila_taxonomy_to_wi_matches(tmp_path, supplementary):
    lila_csv = str(tmp_path / 'lila.csv')
    rows = _lila_rows()
    rows[-1]['taxonomy_string'] = '[(1, broken'
    with open(lila_csv, 'w', newline='') as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    mapping = {'Mysterius Beastus': 'mammalia', 'grousidae': 'bird'}
    if supplementary == 'csv':
        path = str(tmp_path / 'supplementary.csv')
        with open(path, 'w', newline='') as f:
            f.write('lila_name,wi_name\n')
            for k, v in mapping.items():
                f.write('{} , {}\n'.format(k, v))
        mapping = path
    elif supplementary is None:
        mapping = None
    taxonomy_file = str(tmp_path / 'wi.txt')
    with open(taxonomy_file, 'w') as f:
        f.write('\n'.join(WI_TAXONOMY) + '\n')

    def run(side, folder):
        out = os.path.join(folder, 'out.csv')
        value = LILA_TO_WI[side].map_lila_taxonomy_to_wi(
            lila_csv, WI_TAXONOMY if side else taxonomy_file,
            supplementary_mapping=mapping, output_file=out, verbose=True)
        return value, read(out)

    (ours, _), (ref, _) = both(tmp_path, 'lila_to_wi', run)
    assert ours == ref
    by_query = {r['query']: r for r in ours[0]}
    assert by_query['cougar']['mapping_method'] == 'exact'
    assert by_query['flying squirrel']['mapping_method'] == 'ancestor:family'
    assert by_query['lynx']['mapping_method'] == 'ancestor:family'
    assert by_query['fog']['mapping_method'] == 'unmapped'
    if supplementary is not None:
        assert by_query['weird']['mapping_method'] == 'supplementary'
        assert by_query['weird']['wi_prediction_string'].startswith('uuid4')
    jax, port = LILA_TO_WI
    handler = WTU[1].TaxonomyHandler(WI_TAXONOMY)
    assert port.build_wi_name_index(handler) == jax.build_wi_name_index(
        WTU[0].TaxonomyHandler(WI_TAXONOMY))
    assert port.load_supplementary_mapping({'A': 'B'}) == {'a': 'b'}
    assert port.__all__ == jax.__all__


def test_map_lila_cli_matches(tmp_path, monkeypatch, capsys):
    lila_csv = str(tmp_path / 'lila.csv')
    rows = _lila_rows()
    with open(lila_csv, 'w', newline='') as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    taxonomy_file = str(tmp_path / 'wi.txt')
    with open(taxonomy_file, 'w') as f:
        f.write('\n'.join(WI_TAXONOMY) + '\n')
    outs, printed = [], []
    for side, module in enumerate(LILA_TO_WI):
        out = str(tmp_path / 'out{}.csv'.format(side))
        run_main(module, ['map_lila', lila_csv, taxonomy_file, out],
                 monkeypatch)
        outs.append(read(out))
        printed.append(capsys.readouterr().out.replace(out, 'OUT'))
    assert outs[0] == outs[1] and printed[0] == printed[1]
    assert 'unmapped' in printed[0]


#%% split_locations_into_train_val and directory_listing
#%% (tests/test_ecosystem_tools.py)


@pytest.mark.parametrize('kwargs', [
    {'n_random_seeds': 300, 'target_val_fraction': 0.2,
     'default_max_allowable_error': 0.15},
    {'n_random_seeds': 200, 'category_to_max_allowable_error': {'elk': 0.05},
     'category_to_error_weight': {'wolf': 3.0}, 'verbose': True},
    {'n_random_seeds': 100, 'default_max_allowable_error': None,
     'require_complete_coverage': False, 'target_val_fraction': 0.3}])
def test_split_locations_matches(kwargs):
    rng = np.random.RandomState(0)
    locations = {}
    for i in range(40):
        locations['loc{:03d}'.format(i)] = {
            'bear': int(rng.randint(0, 20)),
            'wolf': int(rng.randint(0, 10)),
            'elk': int(rng.randint(0, 30))}
    jax, port = SPLIT
    ours = port.split_locations_into_train_val(locations, **kwargs)
    assert ours == jax.split_locations_into_train_val(locations, **kwargs)
    val_ids, fractions = ours
    assert 0 < len(val_ids) < 40 and val_ids == sorted(val_ids)
    if 'default_max_allowable_error' in kwargs and \
            kwargs['default_max_allowable_error']:
        for frac in fractions.values():
            assert abs(frac - kwargs['target_val_fraction']) <= 0.15
    with pytest.raises(AssertionError):
        port.split_locations_into_train_val(
            locations, n_random_seeds=5,
            category_to_max_allowable_error={'elk': 0.0})


@pytest.mark.parametrize('kwargs', [{}, {'recursive': False},
                                    {'basepath': 'BASE'}])
def test_directory_listing_matches(tmp_path, kwargs):
    def run(side, folder):
        root = os.path.join(folder, 'tree')
        sub = os.path.join(root, 'camA')
        os.makedirs(os.path.join(sub, 'deeper'))
        os.makedirs(os.path.join(root, '.hidden'))
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
            os.path.join(sub, 'img.jpg'))
        for path in ('notes.txt', '.secret', 'camA/deeper/b.png'):
            with open(os.path.join(root, path), 'w') as f:
                f.write('x')
        options = dict(kwargs)
        if 'basepath' in options:
            options['basepath'] = folder
        written = LISTING[side].create_html_index(root, **options)
        again = LISTING[side].create_html_index(root, **options)
        forced = LISTING[side].create_html_index(root, overwrite=True,
                                                 **options)
        pages = {os.path.relpath(p, root): read(p, 'r').replace(folder, '')
                 for p in written}
        return ([os.path.relpath(p, root) for p in written], len(again),
                [os.path.relpath(p, root) for p in forced], pages)

    (ours, _), (ref, _) = both(tmp_path, 'listing', run)
    assert ours == ref
    if not kwargs:
        assert len(ours[0]) == 3
        assert 'camA' in ours[3]['index.html']
        assert 'Preview image' in ours[3]['camA/index.html']
    jax, port = LISTING
    assert port._create_plain_index('', ['b', 'a'], ['x.jpg', 'y.txt']) == \
        jax._create_plain_index('', ['b', 'a'], ['x.jpg', 'y.txt'])


def test_directory_listing_cli_matches(tmp_path, monkeypatch, capsys):
    printed = []
    for side, module in enumerate(LISTING):
        root = tmp_path / 'cli{}'.format(side)
        (root / 'sub').mkdir(parents=True)
        (root / 'sub' / 'a.jpg').write_bytes(b'x')
        run_main(module, ['directory_listing', str(root), '--no_recursion'],
                 monkeypatch)
        printed.append(capsys.readouterr().out)
        assert sorted(os.listdir(str(root))) == ['index.html', 'sub']
    assert printed[0] == printed[1] == 'Wrote 1 index files\n'


#%% The slice's public signatures


SLICE = ('utils/wi_utils', 'utils/wi_taxonomy_utils',
         'data_management/speciesnet_to_md',
         'taxonomy_mapping/map_lila_taxonomy_to_wi_taxonomy',
         'utils/wi_platform_utils', 'visualization/visualize_db',
         'utils/directory_listing', 'utils/split_locations_into_train_val',
         'workflows/download_wi_projects')


def _public(path):
    """{name: signature} of the public functions and classes of [path] (a
    class: its bases and each method's arguments), and the names of its
    public module-level assignments."""

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


@pytest.mark.parametrize('module', SLICE)
def test_public_signatures_match(module):
    want, got = (_public(os.path.join(REPO, package, module + '.py'))
                 for package in ('megadetector_tpu', 'megadetector_tpu_torch'))
    assert got == want and want
