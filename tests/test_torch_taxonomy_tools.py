"""
The port's taxonomy tools against the JAX package's, on the same inputs,
values returned and bytes written: taxonomy_mapping/species_lookup
(initialize_taxonomy_lookup over GBIF and iNat archives served on
loopback, through an injected download_fn and through the default one,
and every lookup helper), taxonomy_release, taxonomy_csv_checker,
validate_lila_category_mappings, retrieve_sample_image and
simple_image_download (injected transports, and the default urllib fetch
against loopback). Mirrors tests/test_taxonomy_tools.py,
test_taxonomy_release.py, test_species_lookup_init.py and
test_taxonomy_api_parity.py. Nothing reaches the network: the archives,
the search answers and the images are written here from a numpy seed.
"""

import csv
import json
import os
import random
import sys
import zipfile

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_format_data as fd  # noqa: E402
from torch_cct_data import pair  # noqa: E402
from torch_format_data import read, run_main  # noqa: E402

# Seeded GBIF and iNat archives (about 300 taxa), shared with
# chip_smoke.py's phase 41
from torch_host_tools_data import taxonomy_archives  # noqa: E402

from megadetector_tpu_torch.utils import url_utils  # noqa: E402

SL = pair('taxonomy_mapping.species_lookup')
TR = pair('taxonomy_mapping.taxonomy_release')
CK = pair('taxonomy_mapping.taxonomy_csv_checker')
VL = pair('taxonomy_mapping.validate_lila_category_mappings')
RS = pair('taxonomy_mapping.retrieve_sample_image')
SD = pair('taxonomy_mapping.simple_image_download')
URL = pair('utils.url_utils')

@pytest.fixture(scope='module')
def site(tmp_path_factory):
    """The two taxonomy archives (backbone.zip and
    inaturalist-taxonomy.dwca.zip, the basenames of
    species_lookup.TAXONOMY_URLS), sample images and an HTML page served on
    loopback."""

    root = str(tmp_path_factory.mktemp('taxonomy_site'))
    common_to_name, species, _ = taxonomy_archives(
        root, np.random.RandomState(0))
    commons = sorted(common_to_name)
    scientifics = [s.lower() for s in species]
    rng = np.random.RandomState(3)
    images = []
    for i in range(6):
        name = 'img{}.{}'.format(i, 'png' if i == 4 else 'jpg')
        data = (b'\x89PNG\r\n\x1a\n' if i == 4 else b'\xff\xd8\xff\xe0') + \
            rng.bytes(300 + 40 * i)
        with open(os.path.join(root, name), 'wb') as f:
            f.write(data)
        images.append(name)
    with open(os.path.join(root, 'page.html'), 'w') as f:
        f.write('<html><body>not an image</body></html>')
    base = url_utils.SingletonHTTPServer.start_server(
        root, port=fd.free_port(), host='127.0.0.1')
    yield dict(root=root, base=base, commons=commons,
               scientifics=scientifics, images=images)
    url_utils.SingletonHTTPServer.stop_server()


def _loopback_download(module_url_utils, base, log):
    """A download_fn that fetches each taxonomy URL's basename from the
    loopback site through the package's own url_utils.download_url."""

    def download(url, dest):
        log.append(url)
        module_url_utils.download_url(
            '{}/{}'.format(base, url.split('/')[-1]), dest, verbose=False)
    return download


def _node(node):
    return None if node is None else (node.taxon_id, node.level, node.name)


def _match(m):
    return (m.query, _node(m.node), m.scientific_name, m.level,
            m.common_name, m.taxonomy_levels, m.taxonomy_string, m.source)


@pytest.fixture(scope='module')
def lookups(site, tmp_path_factory):
    """initialize_taxonomy_lookup of each package over the loopback site:
    (JAX's lookups, the port's, their taxonomy dirs, the URLs fetched)."""

    out = []
    for module, urls in zip(SL, URL):
        folder = str(tmp_path_factory.mktemp('taxonomy'))
        log = []
        result = module.initialize_taxonomy_lookup(
            folder, download_fn=_loopback_download(urls, site['base'], log),
            verbose=False)
        out.append((result, folder, log))
    return out


def _queries(site):
    return (site['commons'][:40] + site['scientifics'][:40] +
            [c.replace('-', ' ') for c in site['commons'][:20]] +
            [s + ' sp' for s in site['scientifics'][:5]] +
            ['unidentified ' + s.split()[0] for s in site['scientifics'][:5]] +
            ['quercus', 'nothing here', 'mammalia', 'genus ' +
             site['scientifics'][0].split()[0]])


def test_initialize_taxonomy_lookup_over_loopback(site, lookups):
    (jax_lookups, jax_dir, jax_log), (ours, our_dir, our_log) = lookups
    assert our_log == jax_log == [SL[0].TAXONOMY_URLS['GBIF'],
                                  SL[0].TAXONOMY_URLS['iNaturalist']]
    assert SL[1].TAXONOMY_URLS == SL[0].TAXONOMY_URLS
    assert SL[1].FILES_TO_UNZIP == SL[0].FILES_TO_UNZIP
    for name, files in SL[0].FILES_TO_UNZIP.items():
        for fn in files:
            assert read(os.path.join(our_dir, name, fn)) == \
                read(os.path.join(jax_dir, name, fn))
    for source in ('gbif', 'inat'):
        a, b = ours[source], jax_lookups[source]
        assert a.synonyms == b.synonyms and a.synonyms
        assert sorted(a.taxonomy.name_to_nodes) == \
            sorted(b.taxonomy.name_to_nodes)
        for query in _queries(site):
            assert _node(a.lookup(query)) == _node(b.lookup(query)), query
    assert ours['gbif'].lookup('quercus') is None
    assert ours['gbif'].lookup(site['commons'][0]) is not None


def test_initialize_bypasses_files_in_place(site, lookups):
    for module, urls, (_, folder, _) in zip(SL, URL, lookups):
        log = []
        module.initialize_taxonomy_lookup(
            folder, download_fn=_loopback_download(urls, site['base'], log),
            verbose=False)
        assert log == []


def test_initialize_default_download_and_unzip(site, tmp_path, monkeypatch):
    """download_fn and unzip_fn left None: the package's own
    url_utils.download_url and path_utils.unzip_file, with TAXONOMY_URLS
    pointed at loopback."""

    got = []
    for i, module in enumerate(SL):
        monkeypatch.setattr(module, 'TAXONOMY_URLS', {
            name: '{}/{}'.format(site['base'], url.split('/')[-1])
            for name, url in SL[0].TAXONOMY_URLS.items()})
        folder = str(tmp_path / str(i))
        result = module.initialize_taxonomy_lookup(folder, verbose=True,
                                                    max_rows=60)
        got.append(({s: sorted(l.taxonomy.name_to_nodes)
                     for s, l in result.items()},
                    sorted(os.listdir(folder))))
    assert got[0] == got[1]
    assert 'backbone.zip' in got[1][1]


def test_initialize_requires_expected_members(tmp_path):
    bad = str(tmp_path / 'bad.zip')
    with zipfile.ZipFile(bad, 'w') as z:
        z.writestr('nothing.txt', 'x')

    def fake_download(url, dest):
        with open(bad, 'rb') as src, open(dest, 'wb') as dst:
            dst.write(src.read())

    for i, module in enumerate(SL):
        with pytest.raises(AssertionError):
            module.initialize_taxonomy_lookup(
                str(tmp_path / 'tax{}'.format(i)), download_fn=fake_download,
                verbose=False)


def test_preferred_match_and_taxonomic_info(site, lookups, capsys):
    (jax_lookups, _, _), (ours, _, _) = lookups
    for query in _queries(site):
        for source in ('gbif', 'inat'):
            a = SL[1].get_preferred_taxonomic_match(query, ours[source])
            b = SL[0].get_preferred_taxonomic_match(query,
                                                    jax_lookups[source])
            assert _match(a) == _match(b), query
            if a.taxonomy_string:
                for n in (1, 2):
                    if len(a.taxonomy_levels) > n:
                        assert _match(SL[1].pop_levels(a, n)) == \
                            _match(SL[0].pop_levels(b, n))
        info = SL[1].get_taxonomic_info(query, lookups=ours)
        assert info == SL[0].get_taxonomic_info(query, lookups=jax_lookups)
        printed = []
        for module, result in ((SL[0], info), (SL[1], info)):
            for verbose in (False, True):
                module.print_taxonomy_matches(result, verbose=verbose)
            printed.append(capsys.readouterr().out)
        assert printed[0] == printed[1]
    node = ours['gbif'].lookup(site['scientifics'][0])
    jax_node = jax_lookups['gbif'].lookup(site['scientifics'][0])
    assert SL[1].traverse_taxonomy(node, ours['gbif'].taxonomy, 'gbif', 'q') \
        == SL[0].traverse_taxonomy(jax_node, jax_lookups['gbif'].taxonomy,
                                   'gbif', 'q')


@pytest.mark.parametrize('value', [
    'Odocoileus virginianus (Zimmermann)', 'über cool', '  --a__b--  ',
    'Black-backed Jackal!', 'Ünïcödé  name'])
def test_string_helpers_match(value):
    for allow_unicode in (False, True):
        assert SL[1].slugify(value, allow_unicode) == \
            SL[0].slugify(value, allow_unicode)
    assert SL[1].clean_species_query(value + ' sp') == \
        SL[0].clean_species_query(value + ' sp')


def test_row_helpers_and_validate_and_convert():
    rows = [{'canonicalName': 'odocoileus virginianus',
             'scientificName': 'odocoileus virginianus (zimmermann)',
             'taxonRank': 'species', 'vernacularName': 'white-tailed deer'},
            {'canonicalName': '', 'scientificName': 'canis lupus',
             'taxonRank': 'species'}]
    for r in rows:
        assert SL[1].get_scientific_name_from_row(r) == \
            SL[0].get_scientific_name_from_row(r)
        assert SL[1].taxonomy_row_to_string(r) == \
            SL[0].taxonomy_row_to_string(r)
    value = (np.int64(5), [1, 'x', (np.int64(2),)])
    assert SL[1].validate_and_convert(value) == \
        SL[0].validate_and_convert(value) == (5, [1, 'x', (2,)])
    for module in SL:
        with pytest.raises(TypeError):
            module.validate_and_convert({'a': 1})


def test_loaders_and_from_files(site, tmp_path):
    root = str(tmp_path)
    with zipfile.ZipFile(os.path.join(site['root'], 'backbone.zip')) as z:
        z.extractall(root)
    with zipfile.ZipFile(os.path.join(
            site['root'], 'inaturalist-taxonomy.dwca.zip')) as z:
        z.extractall(root)
    taxon = os.path.join(root, 'Taxon.tsv')
    for kwargs in ({}, {'max_rows': 30}, {'kingdoms': None}):
        a = SL[1].load_gbif_backbone(taxon, **kwargs)
        b = SL[0].load_gbif_backbone(taxon, **kwargs)
        assert a.synonyms == b.synonyms
        assert sorted(a.taxonomy.name_to_nodes) == \
            sorted(b.taxonomy.name_to_nodes)
    for langs in (('en',), ('fr',), None):
        assert SL[1].load_gbif_vernacular(
            os.path.join(root, 'VernacularName.tsv'), languages=langs) == \
            SL[0].load_gbif_vernacular(
                os.path.join(root, 'VernacularName.tsv'), languages=langs)
    for vern in (None, os.path.join(root, 'VernacularNames-english.csv')):
        a = SL[1].load_inat_taxonomy(os.path.join(root, 'taxa.csv'), vern)
        b = SL[0].load_inat_taxonomy(os.path.join(root, 'taxa.csv'), vern)
        assert a.synonyms == b.synonyms
        assert {k: [_node(n) for n in v]
                for k, v in a.taxonomy.name_to_nodes.items()} == \
            {k: [_node(n) for n in v]
             for k, v in b.taxonomy.name_to_nodes.items()}

    # from_files: a taxon_id/level/name/parent_id CSV and a synonyms JSON
    tax_csv = os.path.join(root, 'tax.csv')
    with open(tax_csv, 'w', newline='') as f:
        writer = csv.writer(f)
        writer.writerow(['taxon_id', 'level', 'name', 'parent_id'])
        writer.writerow(['1', 'family', 'cervidae', ''])
        writer.writerow(['2', 'genus', 'odocoileus', '1'])
        writer.writerow(['3', 'species', 'odocoileus virginianus', '2'])
    syn = os.path.join(root, 'syn.json')
    with open(syn, 'w') as f:
        json.dump({'White-tailed Deer': 'odocoileus virginianus'}, f)
    a = SL[1].SpeciesLookup.from_files(tax_csv, syn)
    b = SL[0].SpeciesLookup.from_files(tax_csv, syn)
    for q in ('white tailed deer', 'White-tailed Deer', 'odocoileus', 'elk'):
        assert a.lookup_name(q) == b.lookup_name(q)
        assert a.map_labels([q]) == b.map_labels([q])


@pytest.mark.parametrize('form', ['gbif', 'csv', 'none'])
def test_species_lookup_cli(site, tmp_path, monkeypatch, capsys, form):
    with zipfile.ZipFile(os.path.join(site['root'], 'backbone.zip')) as z:
        z.extractall(str(tmp_path))
    tax_csv = str(tmp_path / 'tax.csv')
    with open(tax_csv, 'w') as f:
        f.write('taxon_id,level,name,parent_id\n1,genus,odocoileus,\n')
    argv = {'gbif': ['species_lookup', site['commons'][0],
                     site['scientifics'][1], 'nothing', '--gbif_taxon_tsv',
                     str(tmp_path / 'Taxon.tsv')],
            'csv': ['species_lookup', 'odocoileus', '--taxonomy_csv',
                    tax_csv],
            'none': ['species_lookup']}[form]
    out = []
    for module in SL:
        with pytest.raises(SystemExit) as e:
            run_main(module, argv, monkeypatch)
        out.append((e.value.code, capsys.readouterr().out))
    assert out[0] == out[1]


#%% taxonomy_release (tests/test_taxonomy_release.py)


TS_DEER = ("[(1, 'species', 'odocoileus virginianus', "
           "['white-tailed deer']), (2, 'genus', 'odocoileus', []), "
           "(3, 'family', 'cervidae', ['deer'])]")
TS_BEAR = ("[(4, 'species', 'ursus americanus', ['american black bear']), "
           "(5, 'family', 'ursidae', ['bears'])]")


def _release_rows():
    return [
        {'dataset_name': 'ds1', 'query': 'deer', 'taxonomy_level': 'species',
         'scientific_name': 'odocoileus virginianus',
         'common_name': 'white-tailed deer', 'taxonomy_string': TS_DEER,
         'source': 'manual'},
        {'dataset_name': 'ds1', 'query': 'bear', 'taxonomy_level': 'species',
         'scientific_name': 'ursus americanus', 'common_name': '',
         'taxonomy_string': TS_BEAR, 'source': 'manual'},
        {'dataset_name': 'ds2', 'query': 'empty', 'taxonomy_level': '',
         'scientific_name': '', 'common_name': '', 'taxonomy_string': '',
         'source': 'manual'},
        {'dataset_name': 'ds2', 'query': 'deer', 'taxonomy_level': 'family',
         'scientific_name': 'cervidae', 'common_name': 'deer',
         'taxonomy_string': "[(3, 'family', 'cervidae', ['deer'])]",
         'source': 'manual'},
        {'dataset_name': 'ds2', 'query': 'odd', 'taxonomy_level': 'genus',
         'scientific_name': 'wrong',
         'common_name': 'x', 'source': 'manual',
         'taxonomy_string': "(7, 'zoosection', 'oddia', ['odd'])"},
    ]


@pytest.mark.parametrize('ts', [TS_DEER, TS_BEAR, '', '   ', None, 3.5,
                                "(7, 'genus', 'oddia', ['odd'])",
                                "[(8, 'species', 'a b', 'single')]"])
def test_taxonomy_string_helpers_match(ts):
    for name in ('parse_taxonomy_string', 'taxonomy_string_to_scientific',
                 'taxonomy_string_to_level',
                 'taxonomy_string_to_common_name'):
        assert getattr(TR[1], name)(ts) == getattr(TR[0], name)(ts)


def test_consistency_checks_match(lookups):
    (jax_lookups, _, _), (ours, _, _) = lookups
    rows = _release_rows()
    assert TR[1].check_taxonomy_consistency(rows) == \
        TR[0].check_taxonomy_consistency(rows)
    # With a lookup: rows mapped to the taxonomy's own names, one stale
    sci = sorted(ours['gbif'].taxonomy.name_to_nodes)[:6]
    rows2 = [{'dataset_name': 'ds', 'query': s, 'taxonomy_level': 'species',
              'scientific_name': s, 'common_name': '',
              'taxonomy_string': "[(1, 'species', '{}', [])]".format(s)}
             for s in sci]
    rows2[0]['scientific_name'] = sci[1]
    a = TR[1].check_taxonomy_consistency(rows2, lookup=ours['gbif'])
    assert a == TR[0].check_taxonomy_consistency(
        rows2, lookup=jax_lookups['gbif'])
    assert a['scientific_name_mismatches']


def test_preview_release_and_map_new_dataset_bytes(lookups, site, tmp_path,
                                                   capsys):
    (jax_lookups, _, _), (ours, _, _) = lookups
    ds_to_cats = {'ds1': [{'name': 'Deer'}, 'bear'],
                  'ds2': [{'name': 'empty'}, {'name': 'odd'}]}
    names = site['commons'][:8] + site['scientifics'][:6] + \
        ['mystery animal', 'Unidentified ' + site['scientifics'][7]]
    files = []
    for side, (module, lookup) in enumerate(((TR[0], jax_lookups),
                                             (TR[1], ours))):
        root = str(tmp_path / str(side))
        os.makedirs(root)
        csv_path = os.path.join(root, 'taxonomy.csv')
        module.write_taxonomy_csv(_release_rows(), csv_path)
        cats = os.path.join(root, 'cats.json')
        with open(cats, 'w') as f:
            json.dump(ds_to_cats, f)
        preview = module.preview_lila_taxonomy(
            csv_path, os.path.join(root, 'preview'), lookup=lookup['gbif'])
        rel = module.prepare_taxonomy_release(
            csv_path, os.path.join(root, 'release.csv'),
            dataset_to_categories_json=cats)
        rel_all = module.prepare_taxonomy_release(
            csv_path, os.path.join(root, 'release_all.csv'))
        with pytest.raises(ValueError):
            module.prepare_taxonomy_release(
                csv_path, os.path.join(root, 'release_all.csv'))
        module.prepare_taxonomy_release(
            csv_path, os.path.join(root, 'release_all.csv'), overwrite=True)
        new_rows = module.map_new_dataset(
            'newds', names, lookup['gbif'],
            output_csv=os.path.join(root, 'new.csv'))
        module.map_new_dataset('newds2', names[:3], lookup['inat'],
                               output_csv=os.path.join(root, 'new.csv'))
        back = module.read_taxonomy_csv(os.path.join(root, 'new.csv'))
        files.append(dict(
            preview=read(preview), release=read(os.path.join(
                root, 'release.csv')),
            release_all=read(os.path.join(root, 'release_all.csv')),
            new=read(os.path.join(root, 'new.csv')), rel=rel,
            rel_all=rel_all, new_rows=new_rows, back=back,
            out=capsys.readouterr().out.replace(root, '<root>')))
    assert files[1] == files[0]
    assert sum(r['source'] == 'lookup' for r in files[1]['new_rows']) >= 8


@pytest.mark.parametrize('command', ['preview', 'release', None])
def test_taxonomy_release_cli(tmp_path, monkeypatch, capsys, command):
    out = []
    for side, module in enumerate(TR):
        root = str(tmp_path / str(side))
        os.makedirs(root)
        csv_path = os.path.join(root, 'taxonomy.csv')
        module.write_taxonomy_csv(_release_rows(), csv_path)
        if command == 'preview':
            argv = ['tr', 'preview', csv_path, os.path.join(root, 'p')]
            path = os.path.join(root, 'p', 'taxonomy_preview.html')
        elif command == 'release':
            argv = ['tr', 'release', csv_path, os.path.join(root, 'r.csv'),
                    '--overwrite']
            path = os.path.join(root, 'r.csv')
        else:
            argv, path = ['tr'], None
        try:
            run_main(module, argv, monkeypatch)
            code = None
        except SystemExit as e:
            code = e.code
        out.append((code, read(path) if path else None,
                    capsys.readouterr().out.replace(root, '<root>')))
    assert out[0] == out[1]


#%% taxonomy_csv_checker, validate_lila_category_mappings


GOOD = [(1, 'species', 'puma concolor', ['cougar']), (2, 'genus', 'puma', []),
        (3, 'family', 'felidae', [])]


def _row(ds, query, level, name, ancestry):
    return {'dataset_name': ds, 'query': query, 'taxonomy_level': level,
            'scientific_name': name,
            'taxonomy_string': repr(ancestry) if ancestry else ''}


CHECKER_CASES = {
    'consistent': [_row('ds1', 'cougar', 'species', 'puma concolor', GOOD),
                   _row('ds1', 'empty', '', '', None)],
    'mismatches': [_row('ds1', 'cougar', 'genus', 'puma concolor', GOOD),
                   _row('ds1', 'puma', 'species', 'felis concolor', GOOD)],
    'ambiguous': [
        _row('d', 'a', 'genus', 'x', [(1, 'genus', 'x', []),
                                      (2, 'family', 'p1', [])]),
        _row('d', 'b', 'genus', 'x', [(1, 'genus', 'x', []),
                                      (3, 'family', 'p2', [])])],
    'resolved': [
        _row('d', 'a', 'genus', 'x', [(1, 'genus', 'x', []),
                                      (2, 'family', 'p1', [])]),
        _row('d', 'b', 'genus', 'x', [(1, 'genus', 'x', []),
                                      (3, 'subfamily', 'p2', []),
                                      (2, 'family', 'p1', [])])],
    'cycle': [
        _row('d', 'a', 'genus', 'x', [(1, 'genus', 'x', []),
                                      (2, 'family', 'y', [])]),
        _row('d', 'b', 'family', 'y', [(2, 'family', 'y', []),
                                       (1, 'genus', 'x', [])])],
    'unparseable': [dict(_row('d', 'a', 'genus', 'x', None),
                         taxonomy_string='[(1, ')],
}


def _write_checker_csv(path, rows):
    with open(path, 'w', newline='') as f:
        writer = csv.DictWriter(f, fieldnames=[
            'dataset_name', 'query', 'taxonomy_level', 'scientific_name',
            'taxonomy_string'])
        writer.writeheader()
        writer.writerows(rows)


@pytest.mark.parametrize('case', sorted(CHECKER_CASES))
def test_taxonomy_csv_checker_matches(tmp_path, monkeypatch, capsys, case):
    path = str(tmp_path / 'tax.csv')
    _write_checker_csv(path, CHECKER_CASES[case])
    out = []
    for module in CK:
        result = module.check_taxonomy_csv(path, verbose=True)
        printed = capsys.readouterr().out
        with pytest.raises(SystemExit) as e:
            run_main(module, ['checker', path], monkeypatch)
        out.append((result, printed, e.value.code,
                    capsys.readouterr().out))
    assert out[0] == out[1]
    if case == 'ambiguous':
        assert out[1][0]['ambiguous_parent_nodes'] == [('genus', 'x')]


def test_checker_on_map_new_dataset_rows(lookups, site, tmp_path):
    (_, _, _), (ours, _, _) = lookups
    rows = TR[1].map_new_dataset('ds', site['commons'][:10] +
                                 site['scientifics'][:10], ours['inat'])
    path = str(tmp_path / 'mapped.csv')
    TR[1].write_taxonomy_csv(rows, path)
    a = CK[1].check_taxonomy_csv(path, verbose=False)
    assert a == CK[0].check_taxonomy_csv(path, verbose=False)
    assert a['taxon_level_errors'] == [] and not a['cycle']


def test_validate_lila_category_mappings_match(tmp_path, monkeypatch,
                                               capsys):
    path = str(tmp_path / 'tax.csv')
    _write_checker_csv(path, [
        _row('ds1', 'cougar', 'species', 'puma concolor', GOOD),
        _row('ds1', 'mystery', '', '', None),
        dict(_row('Ds2', 'Fox', 'species', 'nan', None))])
    queries = [m.load_taxonomy_queries(path) for m in VL]
    assert queries[0] == queries[1]
    d2c = {'ds1': [{'name': 'Cougar'}, {'name': 'mystery'},
                   {'name': 'unknown beast'}],
           'ds1_bbox': [{'name': 'cougar'}], 'ds2': [{'name': 'fox'}]}
    out = []
    for module in VL:
        result = module.validate_category_mappings(d2c, queries[0],
                                                   verbose=True)
        out.append((result, capsys.readouterr().out))
    assert out[0] == out[1]
    assert out[1][0] == (['ds1:unknown beast'], ['ds1:mystery', 'ds2:fox'])
    cats = str(tmp_path / 'cats.json')
    with open(cats, 'w') as f:
        json.dump(d2c, f)
    out = []
    for module in VL:
        with pytest.raises(SystemExit) as e:
            run_main(module, ['v', cats, path], monkeypatch)
        out.append((e.value.code, capsys.readouterr().out))
    assert out[0] == out[1] and out[1][0] == 1


#%% retrieve_sample_image, simple_image_download


def test_retrieve_sample_image_injectable(tmp_path):
    def fake_search(query, limit):
        assert query == 'white-tailed+deer'
        return ['http://x/a.jpg', 'http://x/b.png', 'http://x/bad.jpg',
                'http://x/c.webp?size=3']

    def fake_fetch(url):
        if 'bad' in url:
            raise IOError('boom')
        return b'IMAGEDATA' + url.encode()

    out = []
    for side, module in enumerate(RS):
        folder = str(tmp_path / str(side))
        paths = module.download_images('white-tailed deer', folder, limit=4,
                                       verbose=True, search_fn=fake_search,
                                       fetch_fn=fake_fetch)
        out.append([(os.path.relpath(p, folder), read(p)) for p in paths])
    assert out[0] == out[1] and len(out[1]) == 3


def test_retrieve_sample_image_default_fetch_over_loopback(site, tmp_path):
    """The default urllib fetch against the loopback site, with a missing
    URL skipped."""

    urls = ['{}/{}'.format(site['base'], n) for n in site['images']] + \
        [site['base'] + '/missing.jpg']
    out = []
    for side, module in enumerate(RS):
        folder = str(tmp_path / str(side))
        paths = module.download_images(
            'red fox', folder, limit=10,
            search_fn=lambda q, limit: urls[:limit])
        out.append([(os.path.basename(p), read(p)) for p in paths])
    assert out[0] == out[1]
    assert [d for _, d in out[1]] == \
        [read(os.path.join(site['root'], n)) for n in site['images']]


def test_simple_image_downloader_injectable(tmp_path):
    jpeg = b'\xff\xd8\xff\xe0' + b'0' * 100
    png = b'\x89PNG' + b'1' * 50
    gif = b'GIF89a' + b'2' * 20
    urls = {'http://x/deer1.jpg': jpeg,
            'http://x/deer2.jpg': b'<HTML>not an image</html>',
            'http://x/deer3.png': png, 'http://x/deer4.gif': gif}

    def fetch_fn(url):
        if url not in urls:
            raise IOError('missing')
        return urls[url]

    out = []
    for side, module in enumerate(SD):
        assert module.check_webpage('http://x/deer1.jpg',
                                    fetch_fn=fetch_fn) == jpeg
        assert module.check_webpage('http://x/nope', fetch_fn=fetch_fn) \
            is None
        d = module.Downloader(extensions=['.jpg'],
                              search_fn=lambda q, limit: list(urls)[:limit],
                              fetch_fn=fetch_fn)
        d.directory = str(tmp_path / str(side)) + '/'
        d.extensions = '.png'
        random.seed(7)
        found = d.search_urls('deer, red fox', limit=3, verbose=True)
        paths = d.download(download_cache=True)
        more = d.download('elk', limit=1)
        out.append((sorted(found), d.get_urls(), sorted(d.extensions),
                    [(os.path.relpath(p, d.directory), read(p))
                     for p in paths + more], sorted(d.get_dirs)))
        d.flush_cache()
        assert d.cached_urls == {}
        assert d.download(download_cache=True) == []
    assert out[0] == out[1]


def test_simple_image_downloader_default_fetch_over_loopback(site, tmp_path):
    urls = ['{}/{}'.format(site['base'], n) for n in site['images']] + \
        [site['base'] + '/page.html', site['base'] + '/missing.jpg']
    out = []
    for side, module in enumerate(SD):
        assert module.check_webpage(site['base'] + '/page.html') is None
        d = module.Downloader(search_fn=lambda q, limit: urls[:limit])
        d.directory = str(tmp_path / str(side))
        random.seed(11)
        paths = d.download('white-tailed deer', limit=len(urls))
        out.append(sorted((os.path.relpath(p, d.directory), read(p))
                          for p in paths))
    assert out[0] == out[1]
    assert len(out[1]) == len(site['images'])
