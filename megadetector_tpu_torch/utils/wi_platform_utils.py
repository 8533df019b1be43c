"""
Wildlife Insights platform client: fetch projects/deployments/images and
push identifications through the WI API.

Behavioral contract follows the reference
(megadetector/utils/wi_platform_utils.py, 1199 LoC of requests-based
API calls): paged listing of projects/deployments/images and download of
image URLs. The HTTP transport is injectable (any callable
(method, url, headers, json) -> dict), so the client is testable offline
and adaptable to proxied environments; the default transport uses
urllib. All calls require a WI API token.

The port's own copy of megadetector_tpu/utils/wi_platform_utils.py:
the same public names, signatures, defaults and output bytes.
"""

import json
import os
import urllib.request

WI_API_BASE = 'https://api.wildlifeinsights.org/api/v1'


def _default_transport(method, url, headers=None, payload=None,
                       timeout=60):
    """urllib-based JSON transport."""

    data = json.dumps(payload).encode('utf-8') if payload is not None \
        else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    if payload is not None:
        req.add_header('Content-Type', 'application/json')
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode('utf-8'))


class WIPlatformClient:
    """
    Minimal WI API client.

    Args:
        api_token: bearer token
        transport: optional callable replacing the HTTP layer (tests,
            proxies)
        api_base: API root
    """

    def __init__(self, api_token, transport=None, api_base=WI_API_BASE):
        self.api_token = api_token
        self.transport = transport or _default_transport
        self.api_base = api_base.rstrip('/')

    def _headers(self):
        return {'Authorization': 'Bearer {}'.format(self.api_token)}

    def _get(self, path, params=None):
        url = self.api_base + path
        if params:
            from urllib.parse import urlencode
            url += '?' + urlencode(params)
        return self.transport('GET', url, headers=self._headers())

    def _paged(self, path, data_key='data', page_size=100,
               max_pages=1000):
        """Iterate a paged listing endpoint."""

        out = []
        for page in range(1, max_pages + 1):
            resp = self._get(path, {'page': page,
                                    'pageSize': page_size})
            rows = resp.get(data_key, [])
            out.extend(rows)
            meta = resp.get('meta', {})
            if not rows or page >= int(meta.get('totalPages', page)):
                break
        return out

    def list_projects(self):
        """All projects visible to the token."""

        return self._paged('/projects')

    def list_deployments(self, project_id):
        """Deployments (camera placements) of a project."""

        return self._paged('/projects/{}/deployments'.format(project_id))

    def list_images(self, project_id, deployment_id=None):
        """Image records of a project (optionally one deployment)."""

        path = '/projects/{}/images'.format(project_id)
        if deployment_id is not None:
            path = '/projects/{}/deployments/{}/images'.format(
                project_id, deployment_id)
        return self._paged(path)

    def download_project_images(self, project_id, output_folder,
                                n_workers=8, url_key='downloadUrl'):
        """
        Download every image of a project into [output_folder]
        (deployment-id subfolders). Returns {url: status dict}.
        """

        from megadetector_tpu_torch.utils.url_utils import \
            parallel_download_urls

        images = self.list_images(project_id)
        url_to_target = {}
        for im in images:
            url = im.get(url_key)
            if not url:
                continue
            deployment = str(im.get('deploymentId', 'unknown'))
            fn = im.get('filename') or url.split('/')[-1].split('?')[0]
            url_to_target[url] = os.path.join(output_folder, deployment,
                                              fn)
        return parallel_download_urls(url_to_target,
                                      n_workers=n_workers)

    def upload_identifications(self, project_id, md_results,
                               confidence_threshold=0.2,
                               batch_size=100):
        """
        Push MD-format detections as WI identification records
        ({'images': [...]} dict or path). Returns the list of API
        responses. The payload mapping mirrors postprocessing/md_to_wi.
        """

        from megadetector_tpu_torch.postprocessing.md_to_wi import md_to_wi
        import tempfile

        if isinstance(md_results, str):
            predictions = md_to_wi(
                md_results, detection_threshold=confidence_threshold)
        else:
            fd, tmp = tempfile.mkstemp(suffix='.json')
            os.close(fd)
            try:
                from megadetector_tpu_torch.utils.ct_utils import write_json
                write_json(tmp, md_results, force_str=True)
                predictions = md_to_wi(
                    tmp, detection_threshold=confidence_threshold)
            finally:
                try:
                    os.remove(tmp)
                except OSError:
                    pass

        responses = []
        records = predictions['predictions']
        for i in range(0, len(records), batch_size):
            payload = {'identifications': records[i:i + batch_size]}
            responses.append(self.transport(
                'POST',
                self.api_base +
                '/projects/{}/identifications'.format(project_id),
                headers=self._headers(), payload=payload))
        return responses


#%% Download-bundle CSV tooling
#
# A WI "download bundle" is a folder of CSVs (projects.csv,
# deployments.csv, images_<project>.csv, sequences.csv...) exported from
# the platform. These readers/writers mirror the reference's contract
# (wi_platform_utils.py:104-676): records keep pandas NaN semantics so
# downstream identified-by / prediction-string logic can distinguish
# "empty" from "absent".


def _read_bundle_csvs(download_folder, prefix, what):
    """
    Records from every CSV named [prefix]*.csv in [download_folder] (or
    a single CSV path), keyed by [what]_id; each key maps to a LIST of
    row dicts because images/sequences appear once per species. Empty
    values are normalized to ''. Returns None when no matching CSV
    exists.
    """

    import pandas as pd
    from collections import defaultdict
    from megadetector_tpu_torch.utils.ct_utils import is_empty

    if os.path.isfile(download_folder):
        csv_files = [download_folder]
        base = os.path.basename(download_folder)
        if not (base.startswith(prefix) and base.endswith('.csv')):
            print('Warning: {} does not look like a {} csv file'.format(
                download_folder, what))
            return None
    else:
        assert os.path.isdir(download_folder), \
            'Could not find folder {}'.format(download_folder)
        csv_files = sorted(
            os.path.join(download_folder, fn)
            for fn in os.listdir(download_folder)
            if fn.startswith(prefix) and fn.endswith('.csv'))

    if len(csv_files) == 0:
        return None

    key = what + '_id'
    id_to_records = defaultdict(list)
    for csv_file in csv_files:
        df = pd.read_csv(csv_file, low_memory=False)
        for _, row in df.iterrows():
            row_dict = row.to_dict()
            record_id = row_dict[key]
            for k in row_dict:
                if is_empty(row_dict[k]):
                    row_dict[k] = ''
            id_to_records[record_id].append(row_dict)

    deployment_ids = {r['deployment_id'] for records in
                      id_to_records.values() for r in records}
    print('Found {} {} rows in {} deployments'.format(
        len(id_to_records), what, len(deployment_ids)))
    return dict(id_to_records)


def read_sequences_from_download_bundle(download_folder):
    """
    All sequences*.csv records in [download_folder] as
    {sequence_id: [row dicts]} (reference: wi_platform_utils.py:104).
    """

    print('Reading sequences from {}'.format(download_folder))
    return _read_bundle_csvs(download_folder, 'sequence', 'sequence')


def read_images_from_download_bundle(download_folder):
    """
    All images_*.csv records in [download_folder] as
    {image_id: [row dicts]} (reference: wi_platform_utils.py:207).
    """

    print('Reading images from {}'.format(download_folder))
    return _read_bundle_csvs(download_folder, 'images_', 'image')


def find_images_in_identify_tab(download_folder_with_identify,
                                download_folder_excluding_identify):
    """
    Diff two bundles (exported with and without "exclude images in
    identify tab") to recover the image records still awaiting review
    (reference: wi_platform_utils.py:306-363). Returns a flat list of
    record dicts.
    """

    with_identify = read_images_from_download_bundle(
        download_folder_with_identify)
    excluding_identify = read_images_from_download_bundle(
        download_folder_excluding_identify)

    ids_with = set(with_identify.keys())
    ids_excluding = set(excluding_identify.keys())
    ids_identify = ids_with.difference(ids_excluding)
    assert len(ids_identify) == len(ids_with) - len(ids_excluding), \
        'The "excluding" bundle contains images absent from the full ' \
        'bundle; these do not look like exports of the same project'

    records = []
    deployments = set()
    for image_id in ids_identify:
        image_records = with_identify[image_id]
        assert len(image_records) > 0
        records.extend(image_records)
        for r in image_records:
            deployments.add(r['deployment_id'])
    print('Found {} records for {} images in the identify tab '
          '({} deployments)'.format(len(records), len(ids_identify),
                                    len(deployments)))
    return records


def _flatten_image_records(image_records):
    """Accept {id: [records]} or [records]; return the flat list."""

    if isinstance(image_records, dict):
        flat = []
        for records in image_records.values():
            flat.extend(records)
        image_records = flat
    assert isinstance(image_records, list) and \
        isinstance(image_records[0], dict), \
        'Illegal image record list format'
    return image_records


def write_prefix_download_command(image_records, download_dir_base,
                                  force_download=False,
                                  download_command_file=None):
    """
    Write a one-command .sh script that bulk-downloads the longest
    common gs:// prefix of every record's 'location'
    (reference: wi_platform_utils.py:365-443). Returns the script path.
    """

    from megadetector_tpu_torch.utils.path_utils import make_executable

    image_records = _flatten_image_records(image_records)
    urls = [r['location'] for r in image_records]
    common_prefix = os.path.commonprefix(urls)
    if common_prefix.startswith('gs://'):
        common_prefix = common_prefix[len('gs://'):]
    if len(common_prefix) > 0 and not common_prefix.endswith('/'):
        common_prefix = os.path.dirname(common_prefix) + '/'

    if download_command_file is None:
        download_command_file = os.path.join(
            download_dir_base, 'download_wi_images_with_prefix.sh')
    os.makedirs(download_dir_base, exist_ok=True)

    no_clobber = '' if force_download else '--no-clobber'
    cmd = 'gcloud storage cp -r {} "gs://{}" "{}"'.format(
        no_clobber, common_prefix, download_dir_base)
    with open(download_command_file, 'w', newline='\n') as f:
        f.write(cmd + '\n')
    make_executable(download_command_file, catch_exceptions=True)
    print('Download script written to {}'.format(download_command_file))
    return download_command_file


def url_to_relative_path(url, image_flattening='deployment'):
    """
    Convert a WI gs:// URL to a local relative path
    (reference: wi_platform_utils.py:445-488).

    image_flattening: 'none' (whole URL minus gs://), 'guid'
    ([GUID].JPG only), or 'deployment'
    (deployment/<id>/.../[GUID].JPG, '_thumb' stripped).
    """

    assert url.startswith('gs://'), 'Illegal URL {}'.format(url)

    if image_flattening is None or image_flattening == 'none':
        return url[len('gs://'):]
    if image_flattening == 'guid':
        return url.split('/')[-1]
    if image_flattening == 'deployment':
        tokens = url.split('/')
        for i_token, token in enumerate(tokens):
            if token == 'deployment':
                assert i_token < len(tokens) - 1
                return '/'.join(tokens[i_token:]).replace('_thumb', '')
        raise AssertionError(
            'Could not find deployment ID for url {}'.format(url))
    raise ValueError(
        'Unrecognized image flattening scheme {}'.format(
            image_flattening))


def write_download_commands(image_records, download_dir_base,
                            force_download=False,
                            n_download_workers=25,
                            download_command_file_base=None,
                            image_flattening='deployment',
                            script_extension=None):
    """
    Write per-image 'gcloud storage cp' commands split across
    [n_download_workers] scripts, plus a master script that runs them
    in parallel and waits (reference: wi_platform_utils.py:490-676).
    Returns the master script path.
    """

    from megadetector_tpu_torch.utils.ct_utils import split_list_into_n_chunks
    from megadetector_tpu_torch.utils.path_utils import (
        insert_before_extension, make_executable)

    image_records = _flatten_image_records(image_records)

    if script_extension is None:
        script_extension = '.bat' if os.name == 'nt' else '.sh'
    else:
        script_extension = script_extension.lower()
        if not script_extension.startswith('.'):
            script_extension = '.' + script_extension
        assert script_extension in ('.bat', '.sh'), \
            'Unrecognized script extension {}'.format(script_extension)
    command_prefix = 'call ' if script_extension == '.bat' else ''

    if image_flattening is None:
        image_flattening = 'none'
    image_flattening = image_flattening.lower().strip()
    assert image_flattening in ('none', 'guid', 'deployment'), \
        'Illegal image flattening strategy {}'.format(image_flattening)

    # Unique URL -> relative path mapping (multi-species rows repeat
    # URLs; conflicting mappings are an export error)
    url_to_relative = {}
    for r in image_records:
        url = r['location']
        relative_path = url_to_relative_path(
            url, image_flattening=image_flattening)
        if url in url_to_relative:
            assert url_to_relative[url] == relative_path, \
                'URL path mapping error'
        else:
            url_to_relative[url] = relative_path

    if download_command_file_base is None:
        download_command_file_base = os.path.join(
            download_dir_base, 'download_wi_images' + script_extension)

    commands = []
    skipped_urls = []
    seen_urls = set()
    for r in image_records:
        url = r['location']
        if url in seen_urls:
            continue
        seen_urls.add(url)
        relative_path = url_to_relative[url]
        abs_path = os.path.join(download_dir_base, relative_path)
        if not force_download and os.path.isfile(abs_path):
            skipped_urls.append(url)
            continue
        commands.append(
            '{}gcloud storage cp --no-clobber "{}" "./{}"'.format(
                command_prefix, url, relative_path))
    print('Generated {} commands for {} image records ({} skipped)'.
          format(len(commands), len(image_records), len(skipped_urls)))

    commands_by_script = split_list_into_n_chunks(commands,
                                                  n_download_workers)
    os.makedirs(os.path.dirname(download_command_file_base),
                exist_ok=True)

    worker_scripts = []
    for i_script in range(n_download_workers):
        if len(commands_by_script[i_script]) == 0:
            continue
        worker_file = insert_before_extension(
            download_command_file_base, str(i_script).zfill(2))
        worker_scripts.append(os.path.basename(worker_file))
        with open(worker_file, 'w', newline='\n') as f:
            for command in commands_by_script[i_script]:
                f.write(command + '\n')
        make_executable(worker_file, catch_exceptions=True)

    with open(download_command_file_base, 'w', newline='\n') as f:
        if script_extension == '.sh':
            for script in worker_scripts:
                f.write('./' + script + ' &\n')
            f.write('wait\n')
            f.write('echo Finished downloads\n')
        else:
            # Parallel execution needs PowerShell from a .bat
            quoted = ",".join("'" + s + "'" for s in worker_scripts)
            f.write('powershell -NoProfile -Command "@({}) | '
                    'ForEach-Object {{ Start-Process $_ -PassThru '
                    '-NoNewWindow }} | Wait-Process"\n'.format(quoted))
            f.write('echo Finished downloads\n')
    make_executable(download_command_file_base, catch_exceptions=True)
    return download_command_file_base


#%% Pushing results to the WI DB (process-CV-response API)
#
# Reference: wi_platform_utils.py:678-1199. All HTTP goes through the
# injectable transport (tests run hermetically); status codes are
# returned like the reference's requests-based implementation.

PROCESS_CV_RESPONSE_URL = \
    'https://api.wildlifeinsights.org/api/v1/data-file/process-CV-response'
GET_AUTH_TOKEN_URL = 'https://api.wildlifeinsights.org/v1/auth/m2m/token'

#: Floor for detection confidences pushed to the platform
MIN_MD_OUTPUT_CONFIDENCE = 0.25

#: Taxonomy fields of a WI result row, in prediction-string order
WI_RESULT_FIELDS = ['wi_taxon_id', 'class', 'order', 'family', 'genus',
                    'species', 'common_name']


def _transport_with_status(transport, method, url, headers, payload):
    """Run a transport call, returning (status_code, body-or-None)."""

    import urllib.error
    try:
        body = (transport or _default_transport)(
            method, url, headers=headers, payload=payload)
        return 200, body
    except urllib.error.HTTPError as e:
        print('Error: {} {}'.format(e.code, e.reason))
        return e.code, None


def get_auth_token(client_secret_info, transport=None, verbose=False):
    """
    Get a temporary (~60 min) auth token from the WI m2m token API
    (reference: wi_platform_utils.py:678-725).

    client_secret_info: {'clientId':..., 'clientSecret':...} or the
    path of a .json file containing that dict. Returns the token string
    or None on error.
    """

    if isinstance(client_secret_info, str):
        assert os.path.isfile(client_secret_info), \
            'Could not find client info file {}'.format(
                client_secret_info)
        with open(client_secret_info) as f:
            client_secret_info = json.load(f)
    assert 'clientId' in client_secret_info and \
        'clientSecret' in client_secret_info, \
        'Invalid client secret info'

    status, content = _transport_with_status(
        transport, 'POST', GET_AUTH_TOKEN_URL,
        {'Content-Type': 'application/json'},
        {'clientId': client_secret_info['clientId'],
         'clientSecret': client_secret_info['clientSecret']})
    if status not in (200, 201) or not isinstance(content, dict) or \
            not content.get('token'):
        if verbose:
            print('Error getting auth token (status {})'.format(status))
        return None
    token = content['token']
    assert isinstance(token, str) and len(token) > 0
    if verbose:
        print('Retrieved auth token of length {}'.format(len(token)))
    return token


def prepare_data_update_auth_headers(auth_token):
    """HTTP headers for the data-update APIs
    (reference: wi_platform_utils.py:728-746)."""

    return {
        'Authorization': 'Bearer ' + auth_token,
        'Content-Type': 'application/json',
    }


def push_results_for_images(payload, headers,
                            url=PROCESS_CV_RESPONSE_URL,
                            transport=None, verbose=False):
    """
    Push one payload (see the generate_*_payload functions) to the
    process-CV-response API; returns the HTTP status code
    (reference: wi_platform_utils.py:749-785).
    """

    status, _ = _transport_with_status(transport, 'POST', url, headers,
                                       payload)
    if status in (200, 201) and verbose:
        print('Successfully pushed results for {} images'.format(
            len(payload['predictions'])))
    return status


def parallel_push_results_for_images(payloads, headers,
                                     url=PROCESS_CV_RESPONSE_URL,
                                     transport=None, verbose=False,
                                     pool_type='thread', n_workers=10):
    """
    push_results_for_images over a list of payloads with a worker pool;
    returns one status code per payload
    (reference: wi_platform_utils.py:788-846).
    """

    if n_workers == 1 or len(payloads) <= 1:
        return [push_results_for_images(p, headers, url=url,
                                        transport=transport,
                                        verbose=verbose)
                for p in payloads]

    assert pool_type in ('thread', 'process')
    # Injectable transports and auth headers don't pickle reliably;
    # pushes are IO-bound anyway, so processes buy nothing
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        results = list(pool.map(
            lambda p: push_results_for_images(
                p, headers, url=url, transport=transport,
                verbose=verbose),
            payloads))
    assert len(results) == len(payloads)
    return results


def _payload_detections(detections):
    """MD detections -> payload detections (labeled, conf-floored)."""

    from megadetector_tpu_torch.detection.run_detector import \
        DEFAULT_DETECTOR_LABEL_MAP

    out = []
    for detection in (detections or []):
        d = detection.copy()
        d['label'] = DEFAULT_DETECTOR_LABEL_MAP[detection['category']]
        if d['conf'] < MIN_MD_OUTPUT_CONFIDENCE:
            d['conf'] = MIN_MD_OUTPUT_CONFIDENCE
        out.append(d)
    return out


def _base_prediction(data_file_id, project_id, prediction_string,
                     score, detections, model_version,
                     prediction_source):

    return {
        'ignore_data_file_checks': True,
        'prediction': prediction_string,
        'prediction_score': score,
        'classifications': {'classes': [prediction_string],
                            'scores': [score]},
        'detections': detections,
        'model_version': model_version,
        'prediction_source': prediction_source,
        'data_file_id': data_file_id,
        'project_id': project_id,
    }


def generate_payload_with_replacement_detections(
        wi_result, detections, prediction_score=0.9,
        model_version='3.1.2', prediction_source='manual_update'):
    """
    Payload keeping [wi_result]'s classification but replacing its
    detections with the MD-format list [detections]
    (reference: wi_platform_utils.py:849-900).
    """

    prediction = _base_prediction(
        wi_result['image_id'], str(wi_result['project_id']),
        wi_result_to_prediction_string(wi_result), prediction_score,
        _payload_detections(detections), model_version,
        prediction_source)
    return {'predictions': [prediction]}


def generate_blank_prediction_payload(data_file_id, project_id,
                                      blank_confidence=0.9,
                                      model_version='3.1.2',
                                      prediction_source='manual_update'):
    """Payload marking one image blank, with no detections
    (reference: wi_platform_utils.py:903-939)."""

    from megadetector_tpu_torch.utils.wi_taxonomy_utils import \
        blank_prediction_string

    prediction = _base_prediction(
        data_file_id, project_id, blank_prediction_string,
        blank_confidence, [], model_version, prediction_source)
    return {'predictions': [prediction]}


def generate_no_cv_result_payload(data_file_id, project_id,
                                  no_cv_confidence=0.9,
                                  model_version='3.1.2',
                                  prediction_source='manual_update'):
    """Payload marking one image "no CV result"
    (reference: wi_platform_utils.py:942-979)."""

    from megadetector_tpu_torch.utils.wi_taxonomy_utils import \
        no_cv_result_prediction_string

    prediction = _base_prediction(
        data_file_id, project_id, no_cv_result_prediction_string,
        no_cv_confidence, [], model_version, prediction_source)
    return {'predictions': [prediction]}


def generate_payload_for_prediction_string(
        data_file_id, project_id, prediction_string,
        prediction_confidence=0.8, detections=None,
        model_version='3.1.2', prediction_source='manual_update'):
    """Payload setting one image to [prediction_string], optionally
    with MD detections (reference: wi_platform_utils.py:982-1039)."""

    from megadetector_tpu_torch.utils.wi_taxonomy_utils import \
        is_valid_prediction_string

    assert is_valid_prediction_string(prediction_string), \
        'Invalid prediction string: {}'.format(prediction_string)
    prediction = _base_prediction(
        data_file_id, project_id, prediction_string,
        prediction_confidence, _payload_detections(detections),
        model_version, prediction_source)
    return {'predictions': [prediction]}


def validate_payload(payload):
    """
    Assert [payload] is compatible with the process-CV-response API
    (reference: wi_platform_utils.py:1042-1107). Returns True.
    """

    from megadetector_tpu_torch.utils.wi_taxonomy_utils import \
        is_valid_prediction_string

    assert isinstance(payload, dict)
    assert set(payload.keys()) == {'predictions'}

    for prediction in payload['predictions']:
        assert 'project_id' in prediction
        if not isinstance(prediction['project_id'], int):
            int(prediction['project_id'])
        assert isinstance(prediction.get('ignore_data_file_checks'),
                          bool)
        assert isinstance(prediction.get('prediction'), str) and \
            len(prediction['prediction'].split(';')) == 7
        assert isinstance(prediction.get('prediction_score'), float)
        assert isinstance(prediction.get('model_version'), str)
        assert isinstance(prediction.get('data_file_id'), str) and \
            len(prediction['data_file_id']) == 36
        classifications = prediction.get('classifications')
        assert isinstance(classifications, dict)
        assert isinstance(classifications.get('classes'), list)
        assert isinstance(classifications.get('scores'), list)
        assert len(classifications['classes']) == \
            len(classifications['scores'])
        for c in classifications['classes']:
            assert is_valid_prediction_string(c)
        for score in classifications['scores']:
            assert isinstance(score, float) and 0 <= score <= 1.0
        assert isinstance(prediction.get('detections'), list)
        for detection in prediction['detections']:
            assert isinstance(detection, dict)
            assert detection.get('category') in ('1', '2', '3')
            assert detection.get('label') in ('animal', 'person',
                                              'vehicle')
            assert isinstance(detection.get('conf'), float) and \
                0 <= detection['conf'] <= 1.0
            assert isinstance(detection.get('bbox'), list) and \
                len(detection['bbox']) == 4
    return True


#%% Working with WI result records


def wi_result_to_prediction_string(r):
    """
    WI result row dict -> semicolon-delimited prediction string, e.g.
    '90d950db-...;mammalia;rodentia;;;;rodent'
    (reference: wi_platform_utils.py:1110-1135).
    """

    import numpy as np
    from megadetector_tpu_torch.utils.wi_taxonomy_utils import \
        is_valid_prediction_string

    values = []
    for field in WI_RESULT_FIELDS:
        v = r[field]
        if isinstance(v, str):
            values.append(v.lower())
        else:
            assert isinstance(v, float) and np.isnan(v)
            values.append('')
    s = ';'.join(values)
    assert is_valid_prediction_string(s)
    return s


def record_is_unidentified(record):
    """
    True when a bundle record has not been human-reviewed: the
    'identified_by' field is NaN, '' (the readers here normalize NaN to
    ''), or 'Computer vision'
    (reference: wi_platform_utils.py:1138-1157).
    """

    import numpy as np

    identified_by = record['identified_by']
    assert isinstance(identified_by, (float, str))
    if isinstance(identified_by, float):
        assert np.isnan(identified_by)
        return True
    return identified_by in ('', 'Computer vision')


def record_lists_are_identical(records_0, records_1, verbose=False):
    """
    Field-by-field comparison (NaN == NaN) of two record lists in
    read_images_from_download_bundle order
    (reference: wi_platform_utils.py:1160-1196).
    """

    from megadetector_tpu_torch.utils.ct_utils import compare_values_nan_equal

    if len(records_0) != len(records_1):
        return False
    for record_0, record_1 in zip(records_0, records_1):
        assert set(record_0.keys()) == set(record_1.keys())
        for k in record_0.keys():
            if not compare_values_nan_equal(record_0[k], record_1[k]):
                if verbose:
                    print('Mismatch on {}: {} vs {}'.format(
                        k, record_0[k], record_1[k]))
                return False
    return True
