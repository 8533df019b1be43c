"""
The port's Wildlife Insights platform tools and download workflow against
the JAX package's, on the same inputs, bytes written and values returned:
utils/wi_platform_utils (WIPlatformClient through an injected transport,
the download-bundle readers, the download scripts, auth, pushes and the
payloads, the record comparisons; auth and pushes also through the default
urllib transport against a loopback server), visualization/visualize_db and
workflows/download_wi_projects (every stage and its CLI). Mirrors
tests/test_wi_platform.py, tests/test_wi_platform_tools.py and
tests/test_misc_tools.py's visualize_db test. Nothing reaches the network.
Inputs come from tests/torch_wi_data.py.
"""

import copy
import json
import os
import sys
import urllib.error

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_wi_data as wd  # noqa: E402
from torch_cct_data import pair  # noqa: E402
from torch_format_data import read, run_main  # noqa: E402
from torch_postprocessing_data import both  # noqa: E402

WI = pair('utils.wi_platform_utils')
VIZ = pair('visualization.visualize_db')
DWP = pair('workflows.download_wi_projects')
PROJECT_ID = 2013431


class FakeTransport:
    """Records calls and serves canned paged responses."""

    def __init__(self, routes):
        self.routes = routes
        self.calls = []

    def __call__(self, method, url, headers=None, payload=None):
        self.calls.append((method, url, headers, copy.deepcopy(payload)))
        path = url.split('/api/v1', 1)[1]
        base = path.split('?')[0]
        page = 1
        if '?' in path:
            from urllib.parse import parse_qs
            qs = parse_qs(path.split('?', 1)[1])
            page = int(qs.get('page', ['1'])[0])
        pages = self.routes.get((method, base), [{'data': []}])
        return pages[min(page, len(pages)) - 1]


#%% WIPlatformClient (tests/test_wi_platform.py)


ROUTES = {
    ('GET', '/projects'): [
        {'data': [{'id': 1}, {'id': 2}], 'meta': {'totalPages': 3}},
        {'data': [{'id': 3}], 'meta': {'totalPages': 3}},
        {'data': [{'id': 4}], 'meta': {'totalPages': 3}}],
    ('GET', '/projects/7/deployments'): [
        {'data': [{'id': 'd1'}], 'meta': {'totalPages': 1}}],
    ('GET', '/projects/7/deployments/d1/images'): [
        {'data': [{'id': 'im1'}], 'meta': {'totalPages': 1}}],
    ('GET', '/projects/7/images'): [
        {'data': [{'id': 'im1'}, {'id': 'im2'}]}, {'data': []}],
}


@pytest.mark.parametrize('call', ['list_projects', 'list_deployments',
                                  'list_images', 'list_images_deployment'])
def test_client_listing_matches(call):
    out = []
    for module in WI:
        t = FakeTransport(ROUTES)
        client = module.WIPlatformClient('tok', transport=t,
                                         api_base=module.WI_API_BASE + '/')
        if call == 'list_projects':
            value = client.list_projects()
        elif call == 'list_deployments':
            value = client.list_deployments(7)
        elif call == 'list_images':
            value = client.list_images(7)
        else:
            value = client.list_images(7, deployment_id='d1')
        out.append((value, t.calls))
    assert out[1] == out[0]
    value, calls = out[1]
    if call == 'list_projects':
        assert [p['id'] for p in value] == [1, 2, 3, 4] and len(calls) == 3
    assert all(c[2]['Authorization'] == 'Bearer tok' for c in calls)
    assert WI[1].WI_API_BASE == WI[0].WI_API_BASE


@pytest.mark.parametrize('batch_size', [1, 2, 100])
def test_upload_identifications_matches(tmp_path, batch_size):
    md = {
        'images': [
            {'file': 'a.jpg',
             'detections': [
                 {'category': '1', 'conf': 0.9,
                  'bbox': [0.1, 0.1, 0.2, 0.2]},
                 {'category': '2', 'conf': 0.1,
                  'bbox': [0.5, 0.5, 0.2, 0.2]}]},
            {'file': 'b.jpg', 'detections': []},
            {'file': 'c.jpg', 'detections': [
                {'category': '3', 'conf': 0.6,
                 'bbox': [0.2, 0.3, 0.2, 0.2]}]},
        ],
        'detection_categories': {'1': 'animal', '2': 'person',
                                 '3': 'vehicle'},
        'info': {'format_version': '1.4'},
    }
    md_file = str(tmp_path / 'md.json')
    with open(md_file, 'w') as f:
        json.dump(md, f)
    out = []
    for module in WI:
        for source in (md_file, copy.deepcopy(md)):
            t = FakeTransport({})
            client = module.WIPlatformClient('tok', transport=t)
            responses = client.upload_identifications(
                5, source, confidence_threshold=0.2, batch_size=batch_size)
            out.append((responses, t.calls))
    assert out[2] == out[0] and out[3] == out[1] and out[0] == out[1]
    responses, calls = out[2]
    assert len(calls) == len(responses) == -(-3 // batch_size)
    assert calls[0][1].endswith('/projects/5/identifications')
    assert 'identifications' in calls[0][3]


def test_download_project_images_matches(tmp_path):
    """download_project_images through file:// URLs (url_utils'
    parallel_download_urls): the same files and statuses."""

    src = tmp_path / 'src'
    src.mkdir()
    rng = np.random.RandomState(0)
    images = []
    for i in range(4):
        path = src / 'im{}.jpg'.format(i)
        path.write_bytes(rng.bytes(64))
        images.append({'downloadUrl': 'file://' + str(path),
                       'deploymentId': 'dep{}'.format(i % 2)})
        if i == 2:
            images[-1]['filename'] = 'named.jpg'
    images.append({'id': 'no-url'})
    routes = {('GET', '/projects/9/images'): [
        {'data': images, 'meta': {'totalPages': 1}}]}

    def run(side, folder):
        client = WI[side].WIPlatformClient('tok',
                                           transport=FakeTransport(routes))
        status = client.download_project_images(9, folder, n_workers=2)
        files = {os.path.relpath(os.path.join(r, f), folder):
                 read(os.path.join(r, f))
                 for r, _, fs in os.walk(folder) for f in fs}
        return sorted(status), files

    (ours, _), (ref, _) = both(tmp_path, 'download', run)
    assert ours == ref
    assert sorted(ours[1]) == ['dep0/im0.jpg', 'dep0/named.jpg',
                               'dep1/im1.jpg', 'dep1/im3.jpg']


#%% Download bundles and scripts (tests/test_wi_platform_tools.py)


@pytest.fixture
def bundle(tmp_path):
    rows = wd.bundle_rows(PROJECT_ID)
    folder = str(tmp_path / 'bundle')
    wd.write_bundle(folder, rows, PROJECT_ID)
    # A sequences file beside it
    import pandas as pd
    pd.DataFrame([{'sequence_id': 's{}'.format(i % 3),
                   'deployment_id': 'dep001', 'is_blank': i % 2,
                   'common_name': ['Puma', '', 'Blank'][i % 3]}
                  for i in range(7)]).to_csv(
        os.path.join(folder, 'sequences.csv'), index=False)
    return folder, rows


def test_read_bundles_match(bundle, tmp_path, capsys):
    folder, rows = bundle
    jax, port = WI
    for reader in ('read_images_from_download_bundle',
                   'read_sequences_from_download_bundle'):
        for source in (folder, os.path.join(
                folder, 'images_{}.csv'.format(PROJECT_ID)),
                os.path.join(folder, 'sequences.csv')):
            ours = getattr(port, reader)(source)
            ref = getattr(jax, reader)(source)
            assert json.dumps(ours, sort_keys=True) == \
                json.dumps(ref, sort_keys=True)
    out = capsys.readouterr().out
    records = port.read_images_from_download_bundle(folder)
    assert len(records) == 8 and len(records[rows[1]['image_id']]) == 2
    unidentified = [r for r in rows if r['identified_by'] == ''][0]
    assert records[unidentified['image_id']][0]['identified_by'] == ''
    assert records[unidentified['image_id']][0]['family'] == ''
    empty = tmp_path / 'empty'
    empty.mkdir()
    assert port.read_images_from_download_bundle(str(empty)) is None
    assert 'Warning' in out


def test_find_images_in_identify_tab_matches(bundle, tmp_path):
    folder, rows = bundle
    excluding = str(tmp_path / 'without')
    identified = [r for r in rows if r['identified_by'] not in
                  ('', 'Computer vision')]
    wd.write_bundle(excluding, identified, PROJECT_ID)
    ours = WI[1].find_images_in_identify_tab(folder, excluding)
    ref = WI[0].find_images_in_identify_tab(folder, excluding)
    key = (lambda r: (r['image_id'], r['common_name']))
    assert sorted(ours, key=key) == sorted(ref, key=key)
    assert {r['image_id'] for r in ours} == {
        r['image_id'] for r in rows
        if r['identified_by'] in ('', 'Computer vision')}
    with pytest.raises(AssertionError):
        WI[1].find_images_in_identify_tab(excluding, folder)


@pytest.mark.parametrize('flattening', [None, 'none', 'guid', 'deployment',
                                        'bogus'])
def test_url_to_relative_path_matches(flattening):
    def call(module, url):
        try:
            return module.url_to_relative_path(url, flattening)
        except (ValueError, AssertionError) as e:
            return type(e).__name__, str(e)

    for url in ('gs://b/deployment/224/prod/directUpload/abc_thumb.JPG',
                'gs://b/x/y.JPG', 'http://b/deployment/1/a.JPG',
                'gs://b/deployment'):
        assert call(WI[1], url) == call(WI[0], url)
    url = 'gs://b/deployment/224/prod/directUpload/abc_thumb.JPG'
    if flattening == 'deployment':
        assert WI[1].url_to_relative_path(url, flattening) == \
            'deployment/224/prod/directUpload/abc.JPG'


def _tree(folder):
    return {os.path.relpath(os.path.join(r, f), folder):
            (read(os.path.join(r, f)),
             os.access(os.path.join(r, f), os.X_OK))
            for r, _, fs in os.walk(folder) for f in fs}


@pytest.mark.parametrize('kwargs', [
    {'n_download_workers': 2, 'script_extension': 'sh'},
    {'n_download_workers': 3, 'script_extension': '.BAT',
     'image_flattening': 'guid'},
    {'n_download_workers': 20, 'image_flattening': None,
     'download_command_file_base': 'sub/get.sh'},
    {'n_download_workers': 1, 'force_download': True,
     'image_flattening': ' Deployment '}])
def test_write_download_commands_matches(bundle, tmp_path, kwargs):
    folder, rows = bundle

    def run(side, out):
        records = WI[side].read_images_from_download_bundle(folder)
        # One file already on disk: skipped unless force_download
        existing = os.path.join(out, WI[side].url_to_relative_path(
            rows[0]['location']))
        os.makedirs(os.path.dirname(existing), exist_ok=True)
        with open(existing, 'w') as f:
            f.write('x')
        options = dict(kwargs)
        if 'download_command_file_base' in options:
            options['download_command_file_base'] = os.path.join(
                out, options['download_command_file_base'])
        master = WI[side].write_download_commands(records, out, **options)
        flat = WI[side].write_download_commands(
            [r for rs in records.values() for r in rs],
            os.path.join(out, 'flat'), n_download_workers=2,
            script_extension='sh')
        return (os.path.relpath(master, out), os.path.relpath(flat, out),
                _tree(out))

    (ours, _), (ref, _) = both(tmp_path, 'commands', run)
    assert ours == ref
    master, _, tree = ours
    assert tree[master][1] is True
    n = sum(line.startswith((b'gcloud', b'call gcloud'))
            for name, (data, _) in tree.items()
            if name != master and not name.startswith('flat')
            for line in data.splitlines())
    flattening = (kwargs.get('image_flattening', 'deployment') or
                  'none').strip().lower()
    skipped = flattening == 'deployment' and \
        not kwargs.get('force_download', False)
    assert n == 8 - skipped
    for module in WI:
        with pytest.raises(IndexError):
            module.write_download_commands([], str(tmp_path))


@pytest.mark.parametrize('force', [False, True])
def test_write_prefix_download_command_matches(bundle, tmp_path, force):
    folder, _ = bundle

    def run(side, out):
        records = WI[side].read_images_from_download_bundle(folder)
        script = WI[side].write_prefix_download_command(
            records, os.path.join(out, 'dl'), force_download=force)
        named = WI[side].write_prefix_download_command(
            [r for rs in records.values() for r in rs][:1], out,
            download_command_file=os.path.join(out, 'one.sh'))
        return os.path.relpath(script, out), os.path.relpath(named, out), \
            _tree(out)

    (ours, out), (ref, _) = both(tmp_path, 'prefix', run)
    assert ours[:2] == ref[:2]
    assert {k: (v[0].replace(out.encode(), b''), v[1])
            for k, v in ours[2].items()} == {
        k: (v[0].replace(_.encode(), b''), v[1])
        for k, v in ref[2].items()}
    cmd = ours[2][ours[0]][0].decode().strip()
    assert cmd.startswith('gcloud storage cp -r' +
                          ('' if force else ' --no-clobber'))
    assert '"gs://bucket_{}/deployment/"'.format(PROJECT_ID) in cmd


#%% Payloads, auth and pushes


def _payloads(module, seed=0):
    rng = np.random.RandomState(seed)
    guid = wd.seeded_uuid(rng)
    detections = [{'category': c, 'conf': conf,
                   'bbox': [0.1, 0.2, 0.3, 0.4]}
                  for c, conf in (('1', 0.1), ('2', 0.6), ('3', 0.25))]
    row = {'image_id': guid, 'project_id': 7, 'wi_taxon_id': 'abc',
           'class': 'Mammalia', 'order': 'Rodentia', 'family': float('nan'),
           'genus': '', 'species': '', 'common_name': 'Rodent'}
    return [
        module.generate_blank_prediction_payload(guid, '1234'),
        module.generate_blank_prediction_payload(
            guid, 5, blank_confidence=0.75, model_version='4.0',
            prediction_source='x'),
        module.generate_no_cv_result_payload(wd.seeded_uuid(rng), 99),
        module.generate_payload_for_prediction_string(
            guid, 7, wd.TAXONOMY_LINES[1], detections=detections),
        module.generate_payload_for_prediction_string(
            guid, '7', wd.BLANK, prediction_confidence=0.5),
        module.generate_payload_with_replacement_detections(row, detections),
        module.generate_payload_with_replacement_detections(
            row, [], prediction_score=0.6, model_version='1',
            prediction_source='y'),
    ]


def test_payloads_match_and_validate():
    jax, port = WI
    ours, ref = _payloads(port), _payloads(jax)
    assert json.dumps(ours) == json.dumps(ref)
    for payload in ours:
        assert port.validate_payload(payload) is True
        assert jax.validate_payload(payload) is True
    det = ours[3]['predictions'][0]['detections']
    assert [d['label'] for d in det] == ['animal', 'person', 'vehicle']
    assert det[0]['conf'] == port.MIN_MD_OUTPUT_CONFIDENCE
    for name in ('PROCESS_CV_RESPONSE_URL', 'GET_AUTH_TOKEN_URL',
                 'MIN_MD_OUTPUT_CONFIDENCE', 'WI_RESULT_FIELDS'):
        assert getattr(port, name) == getattr(jax, name)
    with pytest.raises(AssertionError):
        port.generate_payload_for_prediction_string(
            wd.seeded_uuid(np.random.RandomState(1)), 7, 'not-a-string')


@pytest.mark.parametrize('fault', [
    ('keys', lambda p: p.update(extra=1)),
    ('project', lambda p: p['predictions'][0].update(project_id='x')),
    ('score', lambda p: p['predictions'][0].update(prediction_score=1)),
    ('guid', lambda p: p['predictions'][0].update(data_file_id='abc')),
    ('class', lambda p: p['predictions'][0]['classifications'][
        'classes'].append('a;b')),
    ('label', lambda p: p['predictions'][0]['detections'][0].update(
        label='cat')),
    ('bbox', lambda p: p['predictions'][0]['detections'][0].update(
        bbox=[0, 0, 1]))])
def test_validate_payload_refusals_match(fault):
    name, mutate = fault
    for module in WI:
        payload = _payloads(module)[3]
        mutate(payload)
        with pytest.raises((AssertionError, ValueError)):
            module.validate_payload(payload)


def test_record_helpers_match():
    jax, port = WI
    r = {'wi_taxon_id': 'abc', 'class': 'Mammalia', 'order': 'Rodentia',
         'family': '', 'genus': '', 'species': '', 'common_name': 'Rodent'}
    assert port.wi_result_to_prediction_string(r) == \
        jax.wi_result_to_prediction_string(r) == \
        'abc;mammalia;rodentia;;;;rodent'
    r['family'] = float('nan')
    assert port.wi_result_to_prediction_string(r) == \
        'abc;mammalia;rodentia;;;;rodent'
    for value in (float('nan'), '', 'Computer vision', 'A Human'):
        record = {'identified_by': value}
        assert port.record_is_unidentified(record) == \
            jax.record_is_unidentified(record)
    assert not port.record_is_unidentified({'identified_by': 'A Human'})
    nan = float('nan')
    for a, b in (([{'image_id': 'x', 'v': nan}], [{'image_id': 'x', 'v': nan}]),
                 ([{'image_id': 'x', 'v': nan}], [{'image_id': 'x', 'v': 1.0}]),
                 ([{'image_id': 'x', 'v': nan}], []),
                 ([{'a': 'p', 'b': 2}], [{'a': 'p', 'b': 2}])):
        for verbose in (False, True):
            assert port.record_lists_are_identical(a, b, verbose) == \
                jax.record_lists_are_identical(a, b, verbose)
    assert port.record_lists_are_identical(
        [{'image_id': 'x', 'v': nan}], [{'image_id': 'x', 'v': nan}])
    assert port.prepare_data_update_auth_headers('tok') == \
        jax.prepare_data_update_auth_headers('tok')


@pytest.mark.parametrize('n_workers', [1, 2, 10])
def test_push_results_with_fake_transport_matches(n_workers):
    out = []
    for module in WI:
        calls = []

        def transport(method, url, headers=None, payload=None):
            calls.append((method, url, headers, payload))
            return {'ok': True}

        payloads = _payloads(module)
        headers = module.prepare_data_update_auth_headers('tok123')
        codes = module.parallel_push_results_for_images(
            payloads, headers, transport=transport, n_workers=n_workers,
            verbose=True)
        key = (lambda c: json.dumps(c[3], sort_keys=True))
        out.append((codes, sorted(calls, key=key)))
    assert out[1] == out[0]
    codes, calls = out[1]
    assert codes == [200] * 7 and len(calls) == 7
    assert all(c[1] == WI[1].PROCESS_CV_RESPONSE_URL for c in calls)

    def failing_transport(method, url, headers=None, payload=None):
        raise urllib.error.HTTPError(url, 403, 'Forbidden', {}, None)

    for module in WI:
        assert module.push_results_for_images(
            _payloads(module)[0], {}, transport=failing_transport) == 403


def test_get_auth_token_matches(tmp_path):
    def transport(method, url, headers=None, payload=None):
        assert payload == {'clientId': 'id1', 'clientSecret': 's3cret'}
        assert url == WI[1].GET_AUTH_TOKEN_URL
        return {'token': 'tok-abc'}

    def bad_transport(method, url, headers=None, payload=None):
        return {}

    def refusing_transport(method, url, headers=None, payload=None):
        raise urllib.error.HTTPError(url, 401, 'Unauthorized', {}, None)

    secret_file = str(tmp_path / 'secret.json')
    with open(secret_file, 'w') as f:
        json.dump({'clientId': 'id1', 'clientSecret': 's3cret'}, f)
    info = {'clientId': 'id1', 'clientSecret': 's3cret'}
    for module in WI:
        assert module.get_auth_token(secret_file, transport=transport,
                                     verbose=True) == 'tok-abc'
        for t in (bad_transport, refusing_transport):
            assert module.get_auth_token(info, transport=t,
                                         verbose=True) is None
        with pytest.raises(AssertionError):
            module.get_auth_token({'clientId': 'x'}, transport=transport)


def test_auth_and_parallel_push_over_loopback():
    """get_auth_token and parallel_push_results_for_images (4 threads)
    through the default urllib transport, the WI host rewritten to a
    loopback server: each payload arrives once, as it was generated, with
    the token's headers."""

    port = WI[1]
    with wd.RecordingServer() as server:
        def transport(method, url, headers=None, payload=None):
            url = url.replace('https://api.wildlifeinsights.org', server.url)
            return port._default_transport(method, url, headers=headers,
                                           payload=payload)

        token = port.get_auth_token(
            {'clientId': 'id1', 'clientSecret': 's3cret'},
            transport=transport)
        headers = port.prepare_data_update_auth_headers(token)
        payloads = _payloads(port) * 3
        codes = port.parallel_push_results_for_images(
            payloads, headers, transport=transport, n_workers=4)
        refused = port.push_results_for_images(
            payloads[0], headers, url=server.url + '/missing',
            transport=lambda m, u, headers=None, payload=None:
            port._default_transport('GET', u, headers=headers))
    assert token == 'tok-loopback' and codes == [200] * len(payloads)
    assert refused == 501
    auth, pushes = server.requests[0], server.requests[1:]
    assert auth[0] == '/v1/auth/m2m/token'
    assert auth[2] == {'clientId': 'id1', 'clientSecret': 's3cret'}
    assert all(p[0] == '/api/v1/data-file/process-CV-response' and
               p[1]['Authorization'] == 'Bearer tok-loopback'
               for p in pushes)
    key = (lambda p: json.dumps(p, sort_keys=True))
    assert sorted((p[2] for p in pushes), key=key) == \
        sorted(payloads, key=key)


#%% visualize_db (tests/test_misc_tools.py)


@pytest.mark.parametrize('options', [
    {}, {'num_to_visualize': 3, 'random_seed': 5},
    {'classes_to_include': ['deer'], 'box_thickness': 2, 'viz_size': (40, -1)},
    {'classes_to_exclude': ['fox'], 'box_expansion': 3,
     'num_to_visualize': None}])
def test_visualize_db_matches(tmp_path, options):
    images_dir = str(tmp_path / 'images')
    os.makedirs(os.path.join(images_dir, 'sub'))
    rng = np.random.RandomState(0)
    db = {'images': [], 'annotations': [],
          'categories': [{'id': 1, 'name': 'deer'}, {'id': 2, 'name': 'fox'},
                         {'id': 0, 'name': 'empty'}]}
    for i in range(6):
        name = ('sub/' if i % 2 else '') + 'im{}.jpg'.format(i)
        if i != 5:
            Image.fromarray(rng.randint(0, 255, (60, 80, 3),
                                        dtype=np.uint8)).save(
                os.path.join(images_dir, name))
        db['images'].append({'id': str(i), 'file_name': name, 'width': 80,
                             'height': 60})
        db['annotations'].append({'id': str(i), 'image_id': str(i),
                                  'category_id': i % 3})
        if i % 3:
            db['annotations'][-1]['bbox'] = [10 + i, 10, 30, 20 + i]
    db_file = str(tmp_path / 'db.json')
    with open(db_file, 'w') as f:
        json.dump(db, f)

    def run(side, folder):
        viz = VIZ[side].DbVizOptions()
        for k, v in options.items():
            setattr(viz, k, v)
        html, images = VIZ[side].visualize_db(db_file, folder, images_dir,
                                              viz)
        return os.path.relpath(html, folder), images, _tree(folder)

    (ours, _), (ref, _) = both(tmp_path, 'viz', run)
    assert ours == ref
    assert 'rendered_images/00000_im0.jpg' in ours[2] or options
    html = ours[2]['index.html'][0].decode()
    assert 'Database preview' in html
    if not options:
        assert 'deer' in html and len(ours[1]) == 6
    assert vars(VIZ[1].DbVizOptions()) == vars(VIZ[0].DbVizOptions())


def test_visualize_db_cli_matches(tmp_path, monkeypatch):
    images_dir = tmp_path / 'images'
    images_dir.mkdir()
    Image.fromarray(np.zeros((20, 30, 3), np.uint8)).save(
        str(images_dir / 'a.jpg'))
    db = {'images': [{'id': 'a', 'file_name': 'a.jpg'}],
          'annotations': [{'id': '0', 'image_id': 'a', 'category_id': 1,
                           'bbox': [2, 2, 10, 8]}],
          'categories': [{'id': 1, 'name': 'deer'}]}
    db_file = str(tmp_path / 'db.json')
    with open(db_file, 'w') as f:
        json.dump(db, f)
    trees = []
    for side, module in enumerate(VIZ):
        out = str(tmp_path / 'out{}'.format(side))
        run_main(module, ['visualize_db', db_file, out, str(images_dir),
                          '--num_to_visualize', '1'], monkeypatch)
        trees.append(_tree(out))
    assert trees[0] == trees[1] and len(trees[0]) == 2


#%% download_wi_projects (tests/test_wi_platform_tools.py)


def _wi_base(root, rows):
    """A base folder with one bundle and its images on disk where the
    deployment-flattened COCO expects them, plus a redundant thumbnail;
    the bundle folder's guid seeded."""

    base = os.path.join(root, 'wi')
    bundle = os.path.join(
        base, 'csv_downloads', 'wildlife-insights_{}_project-{}_data'.format(
            wd.seeded_uuid(np.random.RandomState(7)), PROJECT_ID))
    wd.write_bundle(bundle, rows, PROJECT_ID)
    os.makedirs(os.path.join(base, 'csv_downloads', 'not_a_bundle'))
    image_folder = os.path.join(base, 'images', str(PROJECT_ID))
    rng = np.random.RandomState(0)
    for row in rows:
        target = os.path.join(image_folder, row['deployment_id'],
                              row['image_id'] + '.JPG')
        os.makedirs(os.path.dirname(target), exist_ok=True)
        if not os.path.isfile(target):
            Image.fromarray(rng.randint(0, 255, (40, 60, 3),
                                        dtype=np.uint8)).save(target)
    thumb = os.path.join(image_folder, rows[0]['deployment_id'],
                         rows[0]['image_id'] + '_500.JPG')
    Image.fromarray(rng.randint(0, 255, (10, 15, 3),
                                dtype=np.uint8)).save(thumb)
    return base


def _masked_tree(base):
    """_tree of [base] with [base] taken out of every file."""

    return {k: (v[0].replace(base.encode(), b'BASE'), v[1])
            for k, v in _tree(base).items()}


@pytest.mark.parametrize('prepare', [
    {}, {'download_individual_images': True, 'n_download_workers': 3},
    {'download_individual_images': True, 'download_blank_images': False,
     'download_identified_images': False, 'n_download_workers': 2},
    {'download_individual_images': True,
     'download_unidentified_images': False}])
def test_download_wi_projects_workflow_matches(tmp_path, prepare):
    rows = wd.bundle_rows(PROJECT_ID)

    def run(side, folder):
        dwp = DWP[side]
        base = _wi_base(folder, rows)
        values = {'folders': dwp.find_project_download_folders(
            os.path.join(base, 'csv_downloads'))}
        values['prepare'] = dwp.prepare_project_downloads(base, **prepare)
        values['again'] = dwp.prepare_project_downloads(base, **prepare)
        values['check'] = dwp.check_download_completion(base)
        values['thumbnails'] = dwp.find_redundant_thumbnails(base)
        values['deleted'] = dwp.delete_redundant_thumbnails(base)
        values['coco'] = dwp.convert_projects_to_coco(base)
        values['coco_again'] = dwp.convert_projects_to_coco(
            base, force=True, include_blanks=False)
        values['preview'] = dwp.preview_project_coco(base,
                                                     num_to_visualize=3)
        values['sample'] = dwp.sample_project_images(
            base, n_samples_per_project=3)
        values['sample_blanks'] = dwp.sample_project_images(
            base, sample_folder=os.path.join(base, 'with_blanks'),
            include_blanks_in_sample=True, seed=1)
        return json.loads(json.dumps(values).replace(base, 'BASE')), \
            _masked_tree(base)

    (ours, _), (ref, _) = both(tmp_path, 'workflow', run)
    assert ours[0] == ref[0]
    assert ours[1] == ref[1]
    values = ours[0]
    project = values['prepare'][0]
    assert project['id'] == PROJECT_ID
    if not prepare:
        assert len(project['image_urls_to_download']) == 9
        assert 'images/{}/download_images_{}.sh'.format(
            PROJECT_ID, PROJECT_ID) in ours[1]
    r = values['check'][str(PROJECT_ID)]
    assert len(r['missing']) == len(project['image_urls_to_download'])
    assert len(values['deleted']) == 1 and '_500' in values['deleted'][0]
    with open(os.path.join(str(tmp_path), 'workflow', 'port', 'wi', 'images',
                           str(PROJECT_ID), '{}.coco.with_sequences.json'
                           .format(PROJECT_ID))) as f:
        d = json.load(f)
    assert any('seq_id' in im for im in d['images'])
    assert 1 <= len(values['sample']) <= 3
    with pytest.raises(AssertionError):
        DWP[1].prepare_project_downloads(
            os.path.join(str(tmp_path), 'workflow', 'port', 'wi'),
            download_blank_images=False)


@pytest.mark.parametrize('stage', [
    ['prepare', '--download_individual_images', '--n_download_workers', '2',
     '--skip_blank_images'], ['check'], ['thumbnails'], ['coco', '--force'],
    ['preview'], ['sample', '--n_samples_per_project', '2',
                  '--include_blanks_in_sample']])
def test_download_wi_projects_cli_matches(tmp_path, monkeypatch, capsys,
                                          stage):
    rows = wd.bundle_rows(PROJECT_ID, n=5, seed=1)

    def run(side, folder):
        base = _wi_base(folder, rows)
        # Every stage after 'prepare' reads what the earlier ones wrote
        if stage[0] != 'prepare':
            DWP[side].prepare_project_downloads(base)
        if stage[0] in ('preview', 'sample'):
            DWP[side].convert_projects_to_coco(base)
        capsys.readouterr()
        run_main(DWP[side], ['download_wi_projects', base] + stage,
                 monkeypatch)
        printed = capsys.readouterr().out.replace(base, 'BASE')
        return printed, _masked_tree(base)

    (ours, _), (ref, _) = both(tmp_path, 'cli', run)
    assert ours == ref
    for module in DWP:
        with pytest.raises(SystemExit):
            run_main(module, ['download_wi_projects'], monkeypatch)
    helps = capsys.readouterr().out
    assert helps.count('usage:') == 2
