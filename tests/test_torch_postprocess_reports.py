"""
The port's copies of the folder workflow's host modules against the JAX
package's, on the same inputs, byte for byte: the HTML image list, the
detector-output renderer, the thumbnail composite, the preview
(postprocess_batch_results: detection and classification pages, sampling
and sort orders, the ground-truth evaluation, a spawned process pool), the
CSV report, the subsets, the combined outputs, CCT sequences and the EXIF
reader. Inputs come from tests/torch_workflow_data.py (seeded JPEGs and
synthetic MD results).
"""

import datetime
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from megadetector_tpu.data_management import cct_json_utils as jcct
from megadetector_tpu.data_management import read_exif as jexif
from megadetector_tpu.postprocessing import combine_batch_outputs as jcomb
from megadetector_tpu.postprocessing import generate_csv_report as jcsv
from megadetector_tpu.postprocessing import postprocess_batch_results as jpp
from megadetector_tpu.postprocessing import \
    subset_json_detector_output as jsub
from megadetector_tpu.utils import write_html_image_list as jhtml
from megadetector_tpu.visualization import \
    render_images_with_thumbnails as jthumb
from megadetector_tpu.visualization import visualize_detector_output as jviz
from megadetector_tpu_torch.data_management import cct_json_utils as tcct
from megadetector_tpu_torch.data_management import read_exif as texif
from megadetector_tpu_torch.postprocessing import \
    combine_batch_outputs as tcomb
from megadetector_tpu_torch.postprocessing import \
    generate_csv_report as tcsv
from megadetector_tpu_torch.postprocessing import \
    postprocess_batch_results as tpp
from megadetector_tpu_torch.postprocessing import \
    subset_json_detector_output as tsub
from megadetector_tpu_torch.utils import write_html_image_list as thtml
from megadetector_tpu_torch.visualization import \
    render_images_with_thumbnails as tthumb
from megadetector_tpu_torch.visualization import \
    visualize_detector_output as tviz

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_workflow_data as wd  # noqa: E402


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    """Seeded JPEGs in three camera folders, results files over them
    (plain, classified, taxonomy-classified) and a ground truth."""

    root = tmp_path_factory.mktemp('reports')
    images = str(root / 'images')
    files = wd.write_images(images)
    paths = {}
    for name, kwargs in (('plain', {}), ('classified', {'classified': True}),
                         ('taxa', {'classified': True, 'taxa': True})):
        paths[name] = wd.write_json(str(root / '{}.json'.format(name)),
                                    wd.results(files, **kwargs))
    paths['gt'] = wd.write_json(str(root / 'gt.json'),
                                wd.ground_truth(files))
    return {'root': root, 'images': images, 'files': files, **paths}


def _both(root, tag, run):
    """run(module_pair_index, out_dir) for JAX (0) and the port (1) into
    sibling folders; returns the port's folder, then JAX's."""

    dirs = []
    for i, side in enumerate(('jax', 'port')):
        out = str(root / tag / side)
        os.makedirs(out, exist_ok=True)
        run(i, out)
        dirs.append(out)
    return dirs[1], dirs[0]


def test_write_html_image_list_identical(tmp_path):
    images = ['a.jpg', {'filename': 'b/c.jpg', 'title': 'c <i>t</i>',
                        'linkTarget': 'x.html', 'textStyle': 'color:red'}] + \
        [{'filename': 'p{}.jpg'.format(i), 'title': str(i),
          'imageStyle': 'width:{}px'.format(i)} for i in range(7)]
    for options in (None, {'headerHtml': '<h1>h</h1>',
                           'trailerHtml': '<p>t</p>',
                           'maxFiguresPerHtmlFile': 3}):
        got, want = _both(tmp_path, str(bool(options)), lambda i, out: (
            thtml, jhtml)[1 - i].write_html_image_list(
                filename=os.path.join(out, 'index.html'), images=images,
                options=None if options is None else dict(options)))
        wd.assert_same_tree(got, want)


@pytest.mark.parametrize('kwargs', [
    {}, {'sample': 5, 'random_seed': 3, 'confidence_threshold': 0.3},
    {'render_detections_only': True, 'parallelize_rendering': False,
     'output_image_width': 64}])
def test_visualize_detector_output_identical(folder, kwargs):
    outs = {}

    def run(i, out):
        outs[i] = (jviz, tviz)[i].visualize_detector_output(
            folder['classified'], out, folder['images'], **kwargs)

    got, want = _both(folder['root'],
                      'viz_' + '_'.join(sorted(kwargs) or ['default']), run)
    names = wd.assert_same_tree(got, want)
    assert [os.path.relpath(p, got) for p in outs[1]] == \
        [os.path.relpath(p, want) for p in outs[0]]
    assert len(names) == len(outs[1]) > 0


@pytest.mark.parametrize('location', ['right', 'left'])
def test_render_images_with_thumbnails_identical(folder, location):
    files = [os.path.join(folder['images'], f) for f in folder['files']]
    boxes = [[0.1, 0.2, 0.3, 0.25], [0.0, 0.0, 0.5, 0.5],
             [0.6, 0.7, 0.4, 0.3], [0.2, 0.1, 0.05, 0.9], [0.3] * 4]

    def run(i, out):
        (jthumb, tthumb)[i].render_images_with_thumbnails(
            primary_image_filename=files[0], primary_image_width=200,
            secondary_image_filename_list=files[1:6],
            secondary_image_bounding_box_list=boxes,
            cropped_grid_width=120,
            output_image_filename=os.path.join(out, 'tile.jpg'),
            primary_image_location=location)

    wd.assert_same_tree(*_both(folder['root'], 'thumb_' + location, run))
    image = Image.open(os.path.join(folder['images'], folder['files'][3]))
    assert np.array_equal(
        np.asarray(tthumb.crop_image_with_normalized_coordinates(
            image, boxes[0])),
        np.asarray(jthumb.crop_image_with_normalized_coordinates(
            image, boxes[0])))


PREVIEW_CASES = {
    'plain': ('plain', {}),
    'classified': ('classified', {'classification_confidence_threshold':
                                  0.4}),
    'taxa_report': ('taxa', {
        'include_category_descriptions_with_global_counts': True,
        'sort_classification_results_by_count': True,
        'category_name_to_sort_weight': {'canidae': 1}}),
    'sampled_random': ('plain', {'num_images_to_sample': 3,
                                 'sample_seed': 7,
                                 'html_sort_order': 'random',
                                 'include_almost_detections': True}),
    'confidence_paged': ('classified', {
        'html_sort_order': 'confidence', 'max_figures_per_html_file': 2,
        'confidence_threshold': {'animal': 0.5, 'default': 0.3},
        'include_size_range': True,
        'additional_image_fields_to_display': {'failure': 'why'},
        'rendering_bypass_sets': ['non_detections'],
        'job_name_string': 'job', 'model_version_string': 'v5a',
        'footer_text': 'f'}),
    'ground_truth': ('plain', {'gt': True, 'target_recall': 0.5}),
    'ground_truth_no_labels': ('classified', {
        'gt': True, 'negative_classes': ['empty', '#NO_LABELS#']}),
    'spawned_pool': ('classified', {
        'parallelize_rendering_with_threads': False,
        'parallelize_rendering_n_cores': 2}),
}


@pytest.mark.parametrize('case', sorted(PREVIEW_CASES))
def test_preview_identical(folder, case):
    results, fields = PREVIEW_CASES[case]
    fields = dict(fields)
    gt = fields.pop('gt', False)
    returned = {}

    def run(i, out):
        module = (jpp, tpp)[i]
        options = module.PostProcessingOptions()
        options.md_results_file = folder[results]
        options.output_dir = out
        options.image_base_dir = folder['images']
        if gt:
            options.ground_truth_json_file = folder['gt']
        for k, v in fields.items():
            setattr(options, k, v)
        returned[i] = module.process_batch_results(options)

    got, want = _both(folder['root'], 'preview_' + case, run)
    names = wd.assert_same_tree(got, want)
    assert 'index.html' in names and any(
        n.startswith('rendered/') for n in names)
    a, b = returned[1], returned[0]
    assert os.path.relpath(a.output_html_file, got) == \
        os.path.relpath(b.output_html_file, want)
    for key in sorted(vars(b)):
        if key not in ('output_html_file',):
            assert json.dumps(getattr(a, key), default=str,
                              sort_keys=True) == \
                json.dumps(getattr(b, key), default=str, sort_keys=True), key


@pytest.mark.parametrize('results', ['plain', 'classified', 'taxa'])
@pytest.mark.parametrize('threshold', [None, 0.4])
def test_csv_report_identical(folder, results, threshold):
    def run(i, out):
        (jcsv, tcsv)[i].generate_csv_report(
            folder[results], os.path.join(out, 'report.csv'),
            confidence_threshold=threshold)

    wd.assert_same_tree(*_both(folder['root'], 'csv_{}_{}'.format(
        results, threshold), run))


SUBSET_CASES = {
    'confidence': {'confidence_threshold': 0.3,
                   'remove_images_below_confidence': 0.5},
    'categories': {'categories_to_keep': ['2', '3'],
                   'category_thresholds': {'2': 0.2, '3': 0.5}},
    'size': {'min_box_size': 0.01, 'max_box_size': 0.1},
    'failures_and_query': {'remove_failed_images': True,
                           'query': 'cam_b/', 'replacement': 'b/'},
    'anchored_query': {'query': '^cam_a', 'replacement': 'A'},
    'classification_counts': {
        'remove_classification_categories_below_count': 5},
    'split_top': {'split_folders': True, 'split_folder_mode': 'top',
                  'make_folder_relative': True},
    'split_bottom': {'split_folders': True,
                     'split_folder_mode': 'bottom'},
    'split_n_from_top': {'split_folders': True,
                         'split_folder_mode': 'n_from_top',
                         'split_folder_param': 2,
                         'copy_jsons_to_folders': True},
    'keep_list': {'keep_files_in_list': 'LIST'},
}


@pytest.mark.parametrize('case', sorted(SUBSET_CASES))
def test_subset_identical(folder, case):
    fields = dict(SUBSET_CASES[case])
    if fields.get('keep_files_in_list') == 'LIST':
        fields['keep_files_in_list'] = folder['files'][::3]
    returned = {}

    def run(i, out):
        module = (jsub, tsub)[i]
        options = module.SubsetJsonDetectorOutputOptions()
        for k, v in fields.items():
            setattr(options, k, v)
        target = out if options.split_folders else \
            os.path.join(out, 'subset.json')
        if options.copy_jsons_to_folders:
            # Copies land beside the images: give each side its own copy
            target = os.path.join(out, 'splits')
            options.copy_jsons_to_folders = False
        returned[i] = module.subset_json_detector_output(
            folder['classified'], target, options)

    got, want = _both(folder['root'], 'subset_' + case, run)
    wd.assert_same_tree(got, want)
    assert json.dumps(returned[1], default=str) == \
        json.dumps(returned[0], default=str).replace(
            os.path.join('subset_' + case, 'jax'),
            os.path.join('subset_' + case, 'port'))


def test_combine_batch_outputs_identical(folder):
    with open(folder['classified']) as f:
        data = json.load(f)
    shards = []
    for k in range(3):
        shard = dict(data, images=data['images'][k::3])
        if k == 2:
            shard['info'] = dict(shard['info'],
                                 detection_completion_time='2031-01-01')
        shards.append(wd.write_json(
            str(folder['root'] / 'shard{}.json'.format(k)), shard))

    def run(i, out):
        module = (jcomb, tcomb)[i]
        module.combine_batch_output_files(
            shards, os.path.join(out, 'combined.json'))
        module.combine_batch_output_files(
            shards + shards[:1], os.path.join(out, 'dup.json'),
            require_uniqueness=False)
        assert module.combine_batch_output_dictionaries(
            [json.load(open(s)) for s in shards]) == \
            json.load(open(os.path.join(out, 'combined.json')))
        with pytest.raises(Exception):
            module.combine_batch_output_files(shards + shards[:1])

    wd.assert_same_tree(*_both(folder['root'], 'combine', run))


def _exif_image(path, when, gps=None):
    image = Image.new('RGB', (32, 24), (90, 120, 30))
    exif = Image.Exif()
    exif[306] = when  # DateTime
    exif[0x010F] = 'Reconyx'
    exif[0x8769] = {36867: when}  # Exif IFD: DateTimeOriginal
    if gps is not None:
        exif[0x8825] = gps
    image.save(path, exif=exif.tobytes(), quality=90)


@pytest.fixture(scope='module')
def exif_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp('exif')
    base = datetime.datetime(2021, 6, 1, 12, 0, 0)
    gaps = [0, 2, 5, 200, 201, 3000, 3001, 3002]
    gps = {1: 'N', 2: (47.0, 30.0, 15.5), 3: 'W', 4: (122.0, 10.0, 2.25)}
    for cam in ('loc1/RECNX101', 'loc2'):
        os.makedirs(str(root / cam))
        for i, gap in enumerate(gaps):
            when = (base + datetime.timedelta(seconds=gap)).strftime(
                '%Y:%m:%d %H:%M:%S')
            _exif_image(str(root / cam / 'e{}.jpg'.format(i)), when,
                        gps if i == 0 else None)
    Image.new('RGB', (8, 8)).save(str(root / 'loc2' / 'noexif.jpg'))
    return root


def test_read_exif_identical(exif_folder):
    files = sorted(os.path.join(dp, f) for dp, _, fs in
                   os.walk(str(exif_folder)) for f in fs)
    for fn in files:
        assert json.dumps(texif.read_pil_exif(fn), default=str) == \
            json.dumps(jexif.read_pil_exif(fn), default=str)
        for module in (jexif, texif):
            opened = Image.open(fn)
            assert module.read_exif_from_image(fn) == \
                module.read_pil_exif(opened)
        assert texif.get_gps_info(Image.open(fn)) == \
            jexif.get_gps_info(Image.open(fn))
        assert texif.read_exif_tags_for_image(fn) == \
            jexif.read_exif_tags_for_image(fn)

    def run(i, out):
        module = (jexif, texif)[i]
        options = module.ReadExifOptions()
        options.n_workers = 1 + 3 * i
        harvested = module.read_exif_from_folder(
            str(exif_folder), os.path.join(out, 'exif.json'), options)
        module.exif_results_to_cct(harvested,
                                   os.path.join(out, 'cct.json'))
        module.exif_results_to_cct(os.path.join(out, 'exif.json'),
                                   os.path.join(out, 'cct2.json'))

    got, want = _both(exif_folder, 'out', run)
    wd.assert_same_tree(got, want)
    for s in ('2021:06:01 12:00:00', 'not a date', '2021:13:45 99:00:00'):
        assert texif.parse_exif_datetime_string(s) == \
            jexif.parse_exif_datetime_string(s)


def test_cct_sequences_and_index_identical(tmp_path):
    rng = np.random.RandomState(5)
    base = datetime.datetime(2022, 3, 4, 5, 6, 7)

    def image_info():
        rng2 = np.random.RandomState(5)
        out = []
        for i in range(40):
            when = base + datetime.timedelta(
                seconds=int(rng2.choice([0, 3, 30, 61, 400]) * i))
            dt = when.strftime('%Y:%m:%d %H:%M:%S') if i % 9 else \
                (None if i % 2 else 'garbage')
            out.append({'file_name': 'loc{}/im{:02d}.jpg'.format(i % 3, i),
                        'id': 'im{}'.format(i), 'datetime': dt,
                        'location': 'loc{}'.format(i % 3)
                        if i % 11 else None})
        return out

    for interval in (10.0, 60.0, 500.0):
        got, want = image_info(), image_info()
        for module, info in ((tcct, got), (jcct, want)):
            options = module.SequenceOptions()
            options.episode_interval_seconds = interval
            module.create_sequences(info, options)
        assert json.dumps(got, default=str) == json.dumps(want, default=str)

    cct = {'images': image_info(), 'categories': [
        {'id': 1, 'name': 'Deer'}, {'id': 2, 'name': 'Fox'}],
        'annotations': [{'id': 'a{}'.format(i), 'image_id': 'im{}'.format(i),
                         'category_id': int(rng.randint(1, 3))}
                        for i in range(0, 40, 2)]}
    path = wd.write_json(str(tmp_path / 'cct.json'), cct)

    def run(i, out):
        module = (jcct, tcct)[i]
        db = module.IndexedJsonDb(path, b_normalize_paths=True,
                                  filename_replacements={'loc1': 'L1'})
        summary = [db.get_classes_for_image(im) for im in db.db['images']]
        wd.write_json(os.path.join(out, 'classes.json'), summary)
        with open(path) as f:
            d = json.load(f)
        module.parse_datetimes_from_cct_dict(d, 'none')
        module.create_sequences(d)
        module.write_object_with_serialized_datetimes(
            d, os.path.join(out, 'sequences.json'))

    wd.assert_same_tree(*_both(tmp_path, 'index', run))
    for s in ('2022:03:04 05:06:07', '2022-03-04T05:06:07', 'x', None):
        assert tcct.parse_datetime_string(s) == jcct.parse_datetime_string(s)


def test_helper_copies_match(tmp_path):
    """The helpers the slice added to the port's ct_utils, path_utils and
    visualization_utils against the originals."""

    from megadetector_tpu.utils import ct_utils as jct
    from megadetector_tpu.utils import path_utils as jpath
    from megadetector_tpu.visualization import visualization_utils as jvis
    from megadetector_tpu_torch.utils import ct_utils as tct
    from megadetector_tpu_torch.utils import path_utils as tpath
    from megadetector_tpu_torch.visualization import \
        visualization_utils as tvis

    rng = np.random.RandomState(2)
    for _ in range(200):
        a = list(rng.uniform(0, 0.5, 4) + [0, 0, 0.01, 0.01])
        b = list(rng.uniform(0, 0.5, 4) + [0, 0, 0.01, 0.01])
        assert tct.get_iou(a, b) == jct.get_iou(a, b)
    for im in ({'detections': None}, {'detections': []}, 'x',
               {'detections': [{'conf': 0.3}, {'conf': 0.7}]}):
        assert tct.get_max_conf(im) == jct.get_max_conf(im)
    assert tct.invert_dictionary({'a': 1, 'b': 2}) == \
        jct.invert_dictionary({'a': 1, 'b': 2})
    for n in (1, 3, 7):
        for strategy in ('greedy', 'balanced'):
            assert tct.split_list_into_n_chunks(list(range(20)), n, strategy) \
                == jct.split_list_into_n_chunks(list(range(20)), n, strategy)
    for fn in ('a/b/RECNX101/x.jpg', 'a/100EK113/DCIM/x.jpg', 'x.jpg',
               'c\\d\\100MEDIA\\y.JPG', 'site/cam/101_BTCF/z.jpg'):
        assert tct.image_file_to_camera_folder(fn) == \
            jct.image_file_to_camera_folder(fn)
    content = {'when': datetime.datetime(2020, 1, 2, 3, 4, 5),
               'day': datetime.date(2020, 1, 2), 'x': [1.5, 'y'],
               'other': object}
    for kwargs in ({'serialize_datetimes': True, 'force_str': True},
                   {'serialize_datetimes': True}, {'force_str': True}):
        written = {}
        for module, name in ((tct, 'port'), (jct, 'jax')):
            path = str(tmp_path / name / 'w.json')
            try:
                module.write_json(path, content, **kwargs)
                with open(path) as f:
                    written[name] = f.read()
            except TypeError as e:
                written[name] = str(e)
        assert written['port'] == written['jax']
    (tmp_path / 'tree' / 'sub').mkdir(parents=True)
    for name in ('a.JPG', 'sub/b.png', 'sub/c.txt'):
        (tmp_path / 'tree' / name).write_bytes(b'x')
    for kwargs in ({}, {'return_relative_paths': True},
                   {'recursive': False}):
        assert tpath.recursive_file_list(str(tmp_path / 'tree'), **kwargs) \
            == jpath.recursive_file_list(str(tmp_path / 'tree'), **kwargs)
    for name in ('a.JPG', 'b.webp', 'c.txt', 'd'):
        assert tpath.is_image_file(name) == jpath.is_image_file(name)

    path = str(tmp_path / 'e.jpg')
    _exif_image(path, '2021:01:01 00:00:00')
    for width, height in ((-1, -1), (20, -1), (-1, 12), (40, 30), (64, 48)):
        ours = tvis.resize_image(tvis.open_image(path), width, height,
                                 output_file=str(tmp_path / 'p.jpg'),
                                 no_enlarge_width=True)
        ref = jvis.resize_image(jvis.open_image(path), width, height,
                                output_file=str(tmp_path / 'j.jpg'),
                                no_enlarge_width=True)
        assert np.array_equal(np.asarray(ours), np.asarray(ref))
        assert (tmp_path / 'p.jpg').read_bytes() == \
            (tmp_path / 'j.jpg').read_bytes()
    for normalized in (False, True):
        boxes = [[0.1, 0.2, 0.3, 0.4], [0.5, 0.5, 0.2, 0.1]] if normalized \
            else [[3, 2, 10, 8], [12, 10, 6, 9]]
        images = [Image.new('RGB', (32, 24)) for _ in range(2)]
        tvis.render_db_bounding_boxes(boxes, [1, 'fox'], images[0],
                                      label_map={1: 'deer'},
                                      boxes_are_normalized=normalized)
        jvis.render_db_bounding_boxes(boxes, [1, 'fox'], images[1],
                                      label_map={1: 'deer'},
                                      boxes_are_normalized=normalized)
        assert np.array_equal(np.asarray(images[0]), np.asarray(images[1]))
