"""
LILA (lila.science) dataset tooling: the camera-trap dataset index,
metadata download, and per-dataset URL construction.

Behavioral contract follows the reference
(megadetector/data_management/lila/lila_common.py:324): read the LILA
camera-trap dataset index (a hosted CSV), download/unzip per-dataset
metadata files, and build image URLs. Network access is required for the
real index; every function accepts a local override so offline tests and
air-gapped deployments work from cached files.

The port's own copy of megadetector_tpu/data_management/lila/lila_common.py:
the same public names, signatures, defaults and output bytes.
"""

import json
import os
import zipfile

from megadetector_tpu_torch.utils.url_utils import download_url
from megadetector_tpu_torch.utils.ct_utils import write_json

LILA_BASE_URLS = {
    'azure': 'https://lilawildlife.blob.core.windows.net/lila-wildlife/',
    'gcp': 'https://storage.googleapis.com/public-datasets-lila/',
    'aws': 'http://us-west-2.opendata.source.coop.s3.amazonaws.com/'
           'agentmorris/lila-wildlife/',
}

LILA_DATASET_INDEX_URL = \
    'https://lila.science/public/lila_camera_trap_datasets.csv'

#: Per-identification label table for every LILA camera-trap image
#: (reference: lila_common.py:25)
LILA_ALL_IMAGES_URL = \
    'https://lila.science/public/lila_image_urls_and_labels.csv.zip'

#: The released LILA->scientific-name taxonomy mapping
#: (reference: lila_common.py:24)
LILA_TAXONOMY_MAPPING_URL = \
    'https://lila.science/public/lila-taxonomy-mapping_release.csv'

WILDLIFE_INSIGHTS_PAGE_SIZE = 30000
WILDLIFE_INSIGHTS_TAXONOMY_URL = (
    'https://api.wildlifeinsights.org/api/v1/taxonomy/taxonomies-all'
    '?fields=class,order,family,genus,species,authority,taxonomyType,'
    'uniqueIdentifier,commonNameEnglish&page[size]={}'.format(
        WILDLIFE_INSIGHTS_PAGE_SIZE))
WILDLIFE_INSIGHTS_TAXONOMY_LOCAL_JSON_FILENAME = 'wi_taxonomy.json'
WILDLIFE_INSIGHTS_TAXONOMY_LOCAL_CSV_FILENAME = 'wi_taxonomy.csv'


def get_lila_dataset_index(metadata_dir=None, index_url=None,
                           local_index_file=None):
    """
    The LILA dataset index as {dataset name: {column: value}}. Reads
    [local_index_file] when given (offline mode), else downloads the
    hosted CSV into [metadata_dir].
    """

    import csv

    if local_index_file is None:
        assert metadata_dir is not None, \
            'Need metadata_dir (or a local index file)'
        os.makedirs(metadata_dir, exist_ok=True)
        local_index_file = download_url(
            index_url or LILA_DATASET_INDEX_URL,
            os.path.join(metadata_dir, 'lila_camera_trap_datasets.csv'))

    datasets = {}
    with open(local_index_file, newline='', encoding='utf-8') as f:
        for row in csv.DictReader(f):
            name = row.get('name') or row.get('short_name')
            if not name:
                continue
            datasets[name] = dict(row)
    return datasets


def read_lila_metadata(metadata_dir, force_download=False,
                       index_url=None, local_index_file=None):
    """
    Read the LILA dataset index (URLs for each dataset), downloading the
    hosted .csv if necessary; returns {dataset name: {column: value}}
    (reference: lila_common.py:122-162). Offline callers can pass
    [local_index_file].
    """

    return get_lila_dataset_index(metadata_dir=metadata_dir,
                                  index_url=index_url,
                                  local_index_file=local_index_file)


def read_metadata_file_for_dataset(ds_name, metadata_dir,
                                   metadata_table=None, json_url=None,
                                   preferred_cloud='gcp',
                                   force_download=False):
    """
    Download (and unzip if needed) the metadata .json for one dataset;
    returns the local path to the json file (reference:
    lila_common.py:222-246). [ds_name] is a dataset name from the index
    (or, for convenience, an already-loaded dataset-entry dict);
    [metadata_table] is an optional dict from read_lila_metadata();
    [json_url] overrides URL lookup entirely.
    """

    dataset_entry = None
    if isinstance(ds_name, dict):
        dataset_entry = ds_name
    elif json_url is None:
        if metadata_table is None:
            metadata_table = read_lila_metadata(metadata_dir)
        assert ds_name in metadata_table, \
            'Unknown LILA dataset {}'.format(ds_name)
        dataset_entry = metadata_table[ds_name]

    if dataset_entry is not None:
        # Offline/local entries point straight at a metadata file
        if dataset_entry.get('metadata_path'):
            return dataset_entry['metadata_path']
        if json_url is None:
            json_url = dataset_entry.get('json_url') or \
                dataset_entry.get('metadata_url') or \
                dataset_entry.get('metadata_url_{}'.format(
                    preferred_cloud))
    assert json_url, 'Dataset entry has no metadata URL'

    os.makedirs(metadata_dir, exist_ok=True)
    local = download_url(json_url,
                         os.path.join(metadata_dir,
                                      json_url.split('/')[-1]),
                         force_download=force_download)
    if local.endswith('.zip'):
        with zipfile.ZipFile(local) as zf:
            json_names = [n for n in zf.namelist()
                          if n.endswith('.json')]
            assert len(json_names) >= 1
            zf.extract(json_names[0], metadata_dir)
            return os.path.join(metadata_dir, json_names[0])
    return local


def read_lila_all_images_file(metadata_dir, force_download=False,
                              read_to_dataframe=True):
    """
    Download if necessary — then unzip if necessary — the .csv with
    label mappings for all LILA files; returns it as a pandas DataFrame
    (one row per identification), or None if [read_to_dataframe] is
    False (reference: lila_common.py:184-219).
    """

    import pandas as pd

    os.makedirs(metadata_dir, exist_ok=True)
    zip_filename = os.path.join(metadata_dir,
                                LILA_ALL_IMAGES_URL.split('/')[-1])
    download_url(LILA_ALL_IMAGES_URL, zip_filename,
                 force_download=force_download)

    with zipfile.ZipFile(zip_filename, 'r') as z:
        files = z.namelist()
    assert len(files) == 1

    unzipped_csv_filename = os.path.join(metadata_dir, files[0])
    if not os.path.isfile(unzipped_csv_filename):
        with zipfile.ZipFile(zip_filename, 'r') as z:
            z.extractall(metadata_dir)

    if not read_to_dataframe:
        return None
    return pd.read_csv(unzipped_csv_filename)


def read_lila_taxonomy_mapping(metadata_dir, force_download=False):
    """
    Download (if necessary) and read the LILA taxonomy mapping .csv;
    returns a DataFrame with one row per identification (reference:
    lila_common.py:99-119).
    """

    import pandas as pd

    os.makedirs(metadata_dir, exist_ok=True)
    taxonomy_filename = os.path.join(
        metadata_dir, LILA_TAXONOMY_MAPPING_URL.split('/')[-1])
    download_url(LILA_TAXONOMY_MAPPING_URL, taxonomy_filename,
                 force_download=force_download)
    return pd.read_csv(taxonomy_filename)


def read_wildlife_insights_taxonomy_mapping(metadata_dir,
                                            force_download=False):
    """
    Read the Wildlife Insights taxonomy mapping, downloading the .json
    data (and caching it as .csv) if necessary; returns a DataFrame
    (reference: lila_common.py:53-96).
    """

    import pandas as pd

    os.makedirs(metadata_dir, exist_ok=True)
    wi_taxonomy_csv_path = os.path.join(
        metadata_dir, WILDLIFE_INSIGHTS_TAXONOMY_LOCAL_CSV_FILENAME)
    if os.path.exists(wi_taxonomy_csv_path) and not force_download:
        return pd.read_csv(wi_taxonomy_csv_path)

    wi_taxonomy_json_path = os.path.join(
        metadata_dir, WILDLIFE_INSIGHTS_TAXONOMY_LOCAL_JSON_FILENAME)
    download_url(WILDLIFE_INSIGHTS_TAXONOMY_URL, wi_taxonomy_json_path,
                 force_download=force_download)
    with open(wi_taxonomy_json_path, 'r') as f:
        d = json.load(f)

    # Paging isn't implemented; make sure that's not an issue
    assert d['meta']['totalItems'] < WILDLIFE_INSIGHTS_PAGE_SIZE
    df = pd.DataFrame(d['data'])
    df.to_csv(wi_taxonomy_csv_path, index=False)
    return df


def azure_url_to_gcp_http_url(url, error_if_not_azure_url=True):
    """
    Convert a LILA Azure blob URL to the corresponding GCP http URL —
    most files are mirrored on both (reference:
    create_lila_blank_set.py:334-347).
    """

    lila_azure_storage_account = \
        'https://lilawildlife.blob.core.windows.net'
    gcp_bucket_api_url = \
        'https://storage.googleapis.com/public-datasets-lila'
    if error_if_not_azure_url:
        assert url.startswith(lila_azure_storage_account), \
            'Not a LILA Azure URL: {}'.format(url)
    return url.replace(lila_azure_storage_account, gcp_bucket_api_url,
                       1)


def lila_image_url(dataset_entry, image_file_name, preferred_cloud='gcp'):
    """Construct the public URL for one image of a LILA dataset."""

    base = dataset_entry.get('{}_base_url'.format(preferred_cloud))
    if not base:
        prefix = dataset_entry.get('image_base_url',
                                   LILA_BASE_URLS[preferred_cloud])
        base = prefix
    if not base.endswith('/'):
        base += '/'
    return base + image_file_name.lstrip('/')


def select_lila_images_by_species(cct_json_file, species_of_interest):
    """
    Image file names in a LILA CCT metadata file whose annotations
    include any of [species_of_interest] (case-insensitive). This is
    the selection step of the reference's
    data_management/lila/download_lila_subset.py workflow.
    """

    from megadetector_tpu_torch.data_management.cct_json_utils import \
        IndexedJsonDb

    wanted = {s.lower() for s in species_of_interest}
    db = IndexedJsonDb(cct_json_file)
    files = []
    for im in db.db['images']:
        classes = {c.lower() for c in db.get_classes_for_image(im)}
        if classes & wanted:
            files.append(im['file_name'])
    return files


def download_lila_subset(dataset_entry, image_file_names, output_folder,
                         preferred_cloud='gcp', n_workers=20,
                         dry_run=False):
    """
    Download a subset of one LILA dataset's images into
    [output_folder], preserving relative paths (reference:
    data_management/lila/download_lila_subset.py). Returns the
    {url: target} mapping when dry_run (offline tests), else the
    per-URL download status dict from parallel_download_urls.
    """

    from megadetector_tpu_torch.utils.url_utils import parallel_download_urls

    url_to_target = {}
    for fn in image_file_names:
        url = lila_image_url(dataset_entry, fn,
                             preferred_cloud=preferred_cloud)
        url_to_target[url] = os.path.join(output_folder,
                                          fn.lstrip('/'))
    if dry_run:
        return url_to_target
    return parallel_download_urls(url_to_target, n_workers=n_workers)


def generate_lila_per_image_labels(cct_json_file, output_file=None):
    """
    Flatten a LILA CCT metadata file to one record per image with its
    class names (the reference's per-image label table,
    data_management/lila/generate_lila_per_image_labels.py).
    """

    from megadetector_tpu_torch.data_management.cct_json_utils import \
        IndexedJsonDb

    db = IndexedJsonDb(cct_json_file)
    records = []
    for im in db.db['images']:
        records.append({
            'image_id': im['id'],
            'file_name': im['file_name'],
            'location': im.get('location'),
            'datetime': im.get('datetime'),
            'labels': db.get_classes_for_image(im),
        })
    if output_file is not None:
        write_json(output_file, records, force_str=True)
    return records
