"""
The port's copies of the LILA tools (lila_common, lila_reports and the
download_lila_subset and generate_lila_per_image_labels CLIs) against
the JAX package's, offline: every URL the modules know (the dataset
index, the all-images table, the taxonomy mappings) is pointed at the
port's url_utils.SingletonHTTPServer serving a temporary folder on
127.0.0.1, and nothing else on the network is reached. The same return
values, the same downloaded and written files, the same refusals.
"""

import csv
import json
import os
import sys
import zipfile

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_cct_data as cd  # noqa: E402
import torch_format_data as fd  # noqa: E402
from torch_postprocessing_data import both, relative  # noqa: E402

from megadetector_tpu_torch.utils import url_utils  # noqa: E402

COMMON = cd.pair('data_management.lila.lila_common')
REPORTS = cd.pair('data_management.lila.lila_reports')
SUBSET_CLI = cd.pair('data_management.lila.download_lila_subset')
LABELS_CLI = cd.pair('data_management.lila.generate_lila_per_image_labels')

# The hosted files' URLs, each served from the site under its own name
HOSTED = {'LILA_DATASET_INDEX_URL': 'lila_camera_trap_datasets.csv',
          'LILA_ALL_IMAGES_URL': 'lila_image_urls_and_labels.csv.zip',
          'LILA_TAXONOMY_MAPPING_URL': 'lila-taxonomy-mapping_release.csv',
          'WILDLIFE_INSIGHTS_TAXONOMY_URL': 'wi_taxonomy_all.json'}


def _cct(n, species, seed):
    """A LILA-style CCT database of [n] images over [species] (+ empty),
    some images with two annotations, one unannotated."""

    import numpy as np

    rng = np.random.RandomState(seed)
    names = ['empty'] + list(species)
    db = {'info': {'version': '1'}, 'images': [], 'annotations': [],
          'categories': [{'id': i, 'name': n} for i, n in enumerate(names)]}
    for i in range(n):
        db['images'].append({'id': 'i{:02d}'.format(i),
                             'file_name': 'loc{}/im{:02d}.jpg'.format(i % 3,
                                                                      i),
                             'location': 'loc{}'.format(i % 3),
                             'datetime': '2020-01-{:02d} 00:00:00'.format(
                                 i + 1)})
        if i == n - 1:
            continue
        for k in range(1 + (i % 4 == 1)):
            db['annotations'].append({
                'id': 'a{:02d}_{}'.format(i, k),
                'image_id': 'i{:02d}'.format(i),
                'category_id': int(rng.randint(0, len(names)))})
    return db


@pytest.fixture(scope='module')
def site(tmp_path_factory):
    """A LILA site on loopback: the index (three datasets: zipped
    metadata, plain metadata, and one whose metadata is missing), their
    images, the all-images table zipped, the taxonomy mappings."""

    root = str(tmp_path_factory.mktemp('lila_site'))
    port = fd.free_port()
    base = url_utils.SingletonHTTPServer.start_server(root, port=port,
                                                      host='127.0.0.1')
    dbs = {'Alpha Cams': _cct(14, ['Deer', 'puma'], 1),
           'Beta Traps': _cct(9, ['fox', 'puma'], 2)}
    with zipfile.ZipFile(os.path.join(root, 'alpha.json.zip'), 'w') as zf:
        zf.writestr('alpha.json', json.dumps(dbs['Alpha Cams']))
    with open(os.path.join(root, 'beta.json'), 'w') as f:
        json.dump(dbs['Beta Traps'], f)
    for short, db in (('alpha', dbs['Alpha Cams']),
                      ('beta', dbs['Beta Traps'])):
        for im in db['images'][:-2]:
            path = os.path.join(root, short, im['file_name'])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, 'wb') as f:
                f.write(('image ' + im['id'] + short).encode() * 40)
    with open(os.path.join(root, HOSTED['LILA_DATASET_INDEX_URL']), 'w',
              newline='') as f:
        writer = csv.writer(f)
        writer.writerow(['name', 'short_name', 'metadata_url',
                         'metadata_url_aws', 'image_base_url',
                         'gcp_base_url', 'md_results_url'])
        writer.writerow(['Alpha Cams', 'alpha', base + '/alpha.json.zip', '',
                         base + '/alpha', '', base + '/alpha_md.json'])
        writer.writerow(['Beta Traps', 'beta', '', base + '/beta.json', '',
                         base + '/beta/', ''])
        writer.writerow(['', 'Gamma Missing', base + '/gamma.json', '',
                         base + '/gamma/', '', ''])
        writer.writerow(['', '', base + '/nothing.json', '', '', '', ''])
    rows = [['dataset_name', 'url_gcp', 'url_aws', 'common_name'],
            ['Alpha Cams', base + '/alpha/loc0/im00.jpg', 'a0', 'deer'],
            ['Alpha Cams', base + '/alpha/loc1/im01.jpg', 'a1', ''],
            ['Beta Traps', base + '/beta/loc0/im00.jpg', 'b0', 'red fox'],
            ['Beta Traps', base + '/beta/loc2/im02.jpg', 'b2', 'puma']]
    with zipfile.ZipFile(os.path.join(
            root, HOSTED['LILA_ALL_IMAGES_URL']), 'w') as zf:
        zf.writestr('lila_image_urls_and_labels.csv',
                    '\n'.join(','.join(r) for r in rows) + '\n')
    with open(os.path.join(root, HOSTED['LILA_TAXONOMY_MAPPING_URL']),
              'w') as f:
        f.write('dataset_name,query,scientific_name\nAlpha Cams,deer,'
                'odocoileus\nBeta Traps,fox,vulpes vulpes\n')
    with open(os.path.join(root, HOSTED['WILDLIFE_INSIGHTS_TAXONOMY_URL']),
              'w') as f:
        json.dump({'meta': {'totalItems': 2}, 'data': [
            {'class': 'Mammalia', 'genus': 'Vulpes', 'species': 'vulpes',
             'commonNameEnglish': 'Red Fox'},
            {'class': 'Aves', 'genus': 'Corvus', 'species': 'corax',
             'commonNameEnglish': 'Common Raven'}]}, f)
    yield dict(root=root, base=base, dbs=dbs)
    url_utils.SingletonHTTPServer.stop_server()


@pytest.fixture(autouse=True)
def offline(site, monkeypatch):
    """Every hosted URL of both packages' lila_common is the site's."""

    for module in COMMON:
        for name, path in HOSTED.items():
            monkeypatch.setattr(module, name, site['base'] + '/' + path)


def _index(site):
    return site['base'] + '/' + HOSTED['LILA_DATASET_INDEX_URL']


def test_constants_identical():
    ours, ref = COMMON[1], COMMON[0]
    for name in ('LILA_BASE_URLS', 'WILDLIFE_INSIGHTS_PAGE_SIZE',
                 'WILDLIFE_INSIGHTS_TAXONOMY_LOCAL_JSON_FILENAME',
                 'WILDLIFE_INSIGHTS_TAXONOMY_LOCAL_CSV_FILENAME'):
        assert getattr(ours, name) == getattr(ref, name)


@pytest.mark.parametrize('how', ['local', 'index_url', 'default_url'])
def test_dataset_index_identical(site, tmp_path, how):
    def run(side, out):
        module = COMMON[side]
        if how == 'local':
            return module.get_lila_dataset_index(local_index_file=os.path
                                                 .join(site['root'], HOSTED[
                                                     'LILA_DATASET_INDEX_URL'
                                                 ]))
        return module.read_lila_metadata(
            os.path.join(out, 'metadata'),
            index_url=_index(site) if how == 'index_url' else None)

    (ours, ours_dir), (ref, ref_dir) = both(tmp_path, how, run)
    assert ours == ref
    assert sorted(ours) == ['Alpha Cams', 'Beta Traps', 'Gamma Missing']
    if how != 'local':
        cd.assert_same_tree(ours_dir, ref_dir)
    with pytest.raises(AssertionError):
        COMMON[1].get_lila_dataset_index()


METADATA_CASES = {
    'zip_by_name': lambda m, d, site: m.read_metadata_file_for_dataset(
        'Alpha Cams', d, metadata_table=m.read_lila_metadata(
            d, index_url=_index(site))),
    'by_name_no_table': lambda m, d, site:
        m.read_metadata_file_for_dataset('Alpha Cams', d),
    'aws_column': lambda m, d, site: m.read_metadata_file_for_dataset(
        m.read_lila_metadata(d)['Beta Traps'], d, preferred_cloud='aws'),
    'json_url': lambda m, d, site: m.read_metadata_file_for_dataset(
        None, d, json_url=site['base'] + '/beta.json', force_download=True),
    'metadata_path': lambda m, d, site: m.read_metadata_file_for_dataset(
        {'metadata_path': os.path.join(site['root'], 'beta.json')}, d),
}


@pytest.mark.parametrize('case', sorted(METADATA_CASES))
def test_read_metadata_file_for_dataset_identical(site, tmp_path, case):
    def run(side, out):
        return METADATA_CASES[case](COMMON[side], os.path.join(
            out, 'metadata'), site)

    (ours, ours_dir), (ref, ref_dir) = both(tmp_path, case, run)
    assert relative(ours, ours_dir) == relative(ref, ref_dir)
    if case != 'metadata_path':
        cd.assert_same_tree(ours_dir, ref_dir)
    with open(ours) as f:
        assert json.load(f) in site['dbs'].values()


@pytest.mark.parametrize('case', ['unknown', 'no_url', 'missing'])
def test_read_metadata_file_refusals(site, tmp_path, case):
    errors = []
    for side, module in enumerate(COMMON):
        d = str(tmp_path / str(side))
        with pytest.raises(Exception) as info:
            if case == 'unknown':
                module.read_metadata_file_for_dataset(
                    'Nowhere', d, metadata_table={})
            elif case == 'no_url':
                module.read_metadata_file_for_dataset({'name': 'x'}, d)
            else:
                module.read_metadata_file_for_dataset(
                    'Gamma Missing', d, metadata_table=module
                    .read_lila_metadata(d))
        errors.append((type(info.value), str(info.value).replace(d, '')))
    assert errors[1] == errors[0]


def test_url_helpers_identical():
    ours, ref = COMMON[1], COMMON[0]
    azure = 'https://lilawildlife.blob.core.windows.net/lila-wildlife/x/y.jpg'
    for url, strict in ((azure, True), ('https://example.org/a.jpg', False)):
        assert ours.azure_url_to_gcp_http_url(url, strict) == \
            ref.azure_url_to_gcp_http_url(url, strict)
    assert ours.azure_url_to_gcp_http_url(azure) == \
        'https://storage.googleapis.com/public-datasets-lila/lila-wildlife/' \
        'x/y.jpg'
    for module in (ours, ref):
        with pytest.raises(AssertionError, match='Not a LILA Azure URL'):
            module.azure_url_to_gcp_http_url('https://example.org/a.jpg')
    entries = [{}, {'image_base_url': 'https://host/base'},
               {'gcp_base_url': 'https://gcp/x/',
                'image_base_url': 'https://host/base/'},
               {'aws_base_url': 'https://aws/y'}]
    for entry in entries:
        for cloud in ('gcp', 'aws', 'azure'):
            for name in ('loc/im.jpg', '/lead/im.jpg'):
                assert ours.lila_image_url(entry, name, cloud) == \
                    ref.lila_image_url(entry, name, cloud)


def test_lila_helpers_reference_cases(tmp_path):
    """tests/test_breadth_tools.py:167 and :192 on the port."""

    ours = COMMON[1]
    index_csv = str(tmp_path / 'index.csv')
    with open(index_csv, 'w') as f:
        f.write('name,json_url,image_base_url\nTest Dataset,'
                'https://example/x.json,https://example/images/\n')
    index = ours.get_lila_dataset_index(local_index_file=index_csv)
    assert ours.lila_image_url(index['Test Dataset'], 'loc/im.jpg') == \
        'https://example/images/loc/im.jpg'
    cct = {'images': [{'id': 'im0', 'file_name': 'loc1/a.jpg'},
                      {'id': 'im1', 'file_name': 'loc2/b.jpg'},
                      {'id': 'im2', 'file_name': 'loc1/c.jpg'}],
           'annotations': [{'id': 0, 'image_id': 'im0', 'category_id': 1},
                           {'id': 1, 'image_id': 'im1', 'category_id': 2},
                           {'id': 2, 'image_id': 'im2', 'category_id': 1}],
           'categories': [{'id': 1, 'name': 'Deer'},
                          {'id': 2, 'name': 'empty'}]}
    labels = ours.generate_lila_per_image_labels(cct)
    assert labels[0]['labels'] == ['deer']
    assert labels == COMMON[0].generate_lila_per_image_labels(cct)
    cct_file = str(tmp_path / 'cct.json')
    with open(cct_file, 'w') as f:
        json.dump(cct, f)
    files = ours.select_lila_images_by_species(cct_file, ['deer'])
    assert sorted(files) == ['loc1/a.jpg', 'loc1/c.jpg']
    mapping = ours.download_lila_subset(
        {'image_base_url': 'https://example/images/'}, files,
        str(tmp_path / 'out'), dry_run=True)
    assert mapping['https://example/images/loc1/a.jpg'] == \
        os.path.join(str(tmp_path / 'out'), 'loc1/a.jpg')


@pytest.mark.parametrize('species', [['deer'], ['PUMA', 'fox'], ['zebra']])
def test_select_and_labels_identical(site, tmp_path, species):
    db_file = str(tmp_path / 'alpha.json')
    with open(db_file, 'w') as f:
        json.dump(site['dbs']['Alpha Cams'], f)

    def run(side, out):
        module = COMMON[side]
        return (module.select_lila_images_by_species(db_file, species),
                module.generate_lila_per_image_labels(
                    db_file, os.path.join(out, 'labels.json')))

    (ours, ours_dir), (ref, ref_dir) = both(tmp_path, 'labels', run)
    assert ours == ref
    cd.assert_same_tree(ours_dir, ref_dir)


@pytest.mark.parametrize('n_workers,dry_run', [(1, True), (1, False),
                                               (8, False)])
def test_download_lila_subset_identical(site, tmp_path, n_workers, dry_run):
    """The port with [n_workers] against JAX's one: the same status per
    URL (two images the site lacks fail) and the same files, each the
    site's bytes."""

    db = site['dbs']['Alpha Cams']
    files = [im['file_name'] for im in db['images']]
    entry = {'image_base_url': site['base'] + '/alpha/'}

    def run(side, out):
        return COMMON[side].download_lila_subset(
            entry, files, out, n_workers=n_workers if side else 1,
            dry_run=dry_run)

    (ours, ours_dir), (ref, ref_dir) = both(tmp_path, 'download', run)
    assert relative(ours, ours_dir) == relative(ref, ref_dir)
    if dry_run:
        assert len(ours) == len(files) and os.listdir(ours_dir) == []
        return
    got = cd.assert_same_tree(ours_dir, ref_dir)
    assert got == sorted(files[:-2])
    assert [s['status'] for s in ours.values()].count('error') == 2
    for name in got:
        assert fd.read(os.path.join(ours_dir, name)) == fd.read(
            os.path.join(site['root'], 'alpha', name))


def test_all_images_and_taxonomy_tables_identical(site, tmp_path):
    """read_lila_all_images_file (with and without the frame),
    read_lila_taxonomy_mapping, read_wildlife_insights_taxonomy_mapping
    (downloaded, then read from its cached CSV): equal frames and files."""

    def run(side, out):
        module = COMMON[side]
        d = os.path.join(out, 'metadata')
        return [module.read_lila_all_images_file(d, read_to_dataframe=False),
                module.read_lila_all_images_file(d),
                module.read_lila_taxonomy_mapping(d),
                module.read_wildlife_insights_taxonomy_mapping(d),
                module.read_wildlife_insights_taxonomy_mapping(d)]

    (ours, ours_dir), (ref, ref_dir) = both(tmp_path, 'tables', run)
    assert ours[0] is None and ref[0] is None
    for a, b in zip(ours[1:], ref[1:]):
        assert a.equals(b) and list(a.columns) == list(b.columns)
    assert len(ours[1]) == 4 and len(ours[3]) == 2
    cd.assert_same_tree(ours_dir, ref_dir)


def test_find_images_for_species_identical(site):
    import pandas as pd

    df = COMMON[1].read_lila_all_images_file(os.path.join(
        site['root'], 'metadata_find'))
    assert isinstance(df, pd.DataFrame)
    outs = []
    for module in SUBSET_CLI:
        outs.append([module.find_images_for_species(df, species, provider)
                     for species in (['deer'], ['fox', 'puma'], ['x'])
                     for provider in ('gcp', 'aws')])
        found = {}
        for _, row in df.iterrows():
            module.find_items(row, ['fox'], found)
        outs[-1].append(found)
    assert outs[1] == outs[0]
    assert outs[1][2][0] == {'Beta Traps': [
        site['base'] + '/beta/loc0/im00.jpg',
        site['base'] + '/beta/loc2/im02.jpg']}


def _index_table(site):
    return COMMON[1].get_lila_dataset_index(local_index_file=os.path.join(
        site['root'], HOSTED['LILA_DATASET_INDEX_URL']))


def test_lila_reports_identical(site, tmp_path, capsys):
    """Annotation and image counts (the missing dataset skipped, its
    message printed), a seeded test set and blank set, the links, the URL
    probe over the site."""

    table = _index_table(site)
    printed = []

    def run(side, out):
        module = REPORTS[side]
        d = os.path.join(out, 'metadata')
        value = [
            module.get_lila_annotation_counts(
                table, d, os.path.join(out, 'annotations.json')),
            module.get_lila_image_counts(
                table, d, os.path.join(out, 'images.json'),
                datasets=['Alpha Cams']),
            module.get_lila_annotation_counts(metadata_dir=d),
            module.create_lila_test_set(table['Alpha Cams'], d, 3, 4,
                                        seed=5),
            module.create_lila_test_set(table['Alpha Cams'], d, seed=1),
            module.create_lila_blank_set(table, d, 2, os.path.join(
                out, 'blanks.json'), seed=9),
            module.create_links_to_md_results_files(
                table, os.path.join(out, 'links.json')),
            module.validate_lila_metadata_urls(table, check_images=True,
                                               timeout=5)]
        printed.append(capsys.readouterr().out.replace(out, ''))
        return value

    (ours, ours_dir), (ref, ref_dir) = both(tmp_path, 'reports', run)
    assert relative(ours, ours_dir) == relative(ref, ref_dir)
    cd.assert_same_tree(ours_dir, ref_dir)
    assert printed[1] == printed[0] and 'Skipping Gamma Missing' in printed[0]
    assert {k: v['metadata_ok'] for k, v in ours[7].items()} == {
        'Alpha Cams': True, 'Beta Traps': False, 'Gamma Missing': False}


def test_lila_reports_reference_case(tmp_path):
    """tests/test_ecosystem_tools.py:290 on the port."""

    reports = REPORTS[1]
    cct = {'images': [{'id': 'i{}'.format(k), 'file_name': 'i{}.jpg'.format(
        k)} for k in range(10)],
        'annotations': [{'id': 'a{}'.format(k), 'image_id': 'i{}'.format(k),
                         'category_id': 0 if k < 6 else 1}
                        for k in range(10)],
        'categories': [{'id': 0, 'name': 'empty'}, {'id': 1, 'name': 'puma'}]}
    cct_file = str(tmp_path / 'ds.json')
    with open(cct_file, 'w') as f:
        json.dump(cct, f)
    entry = {'name': 'test_ds', 'metadata_path': cct_file,
             'image_base_url': 'https://example.com/imgs',
             'md_results_url': 'https://example.com/md.json'}
    index = {'test_ds': entry}
    assert reports.get_lila_annotation_counts(index)['test_ds'] == {
        'empty': 6, 'puma': 4}
    assert reports.get_lila_image_counts(index)['test_ds']['puma'] == 4
    picks = reports.create_lila_test_set(entry, n_empty_per_dataset=2,
                                         n_non_empty_per_dataset=2)
    assert sum(p['is_empty'] for p in picks) == 2
    assert all(p['url'].startswith('https://example.com/imgs')
               for p in picks)
    blanks = reports.create_lila_blank_set(index, n_blanks_per_dataset=3)
    assert len(blanks) == 3 and all(b['dataset'] == 'test_ds'
                                    for b in blanks)
    assert reports.create_links_to_md_results_files(index)[
        'test_ds'].endswith('md.json')


@pytest.mark.parametrize('cli', ['download', 'download_max', 'labels'])
def test_lila_cli_identical(site, tmp_path, cli, monkeypatch, capsys):
    """download_lila_subset and generate_lila_per_image_labels through
    sys.argv: the index comes from the site (the hosted index's URL is
    the site's), the same files and printed text; without arguments the
    same help."""

    pair = LABELS_CLI if cli == 'labels' else SUBSET_CLI
    printed = []

    def run(side, out):
        d = os.path.join(out, 'metadata')
        if cli == 'labels':
            argv = ['Alpha Cams', os.path.join(out, 'labels.json'),
                    '--metadata_dir', d]
        else:
            argv = ['Alpha Cams', os.path.join(out, 'images'), '--species',
                    'puma', 'Deer', '--metadata_dir', d, '--n_workers', '3']
            if cli == 'download_max':
                argv += ['--max_images', '2']
        fd.run_main(pair[side], [cli] + argv, monkeypatch)
        printed.append(capsys.readouterr().out.replace(out, ''))

    files = cd.assert_same_tree(*[f for _, f in both(tmp_path, cli, run)])
    assert printed[1] == printed[0]
    if cli == 'download_max':
        assert len([f for f in files if f.startswith('images/')]) == 2
    helps = []
    for module in pair:
        with pytest.raises(SystemExit) as info:
            fd.run_main(module, [cli], monkeypatch)
        assert info.value.code in (0, None)
        helps.append(capsys.readouterr().out)
    assert helps[1] == helps[0] and 'usage: ' + cli in helps[0]
    messages = []
    for module in SUBSET_CLI:
        with pytest.raises(AssertionError) as info:
            fd.run_main(module, ['x', 'Nowhere', str(tmp_path / 'n'),
                                 '--species', 'fox', '--metadata_dir',
                                 str(tmp_path / 'm')], monkeypatch)
        messages.append(str(info.value))
    assert messages[1] == messages[0] and \
        'Alpha Cams, Beta Traps, Gamma Missing' in messages[0]
