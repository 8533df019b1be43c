"""
Model registry for the port: its own copy of the parts of
megadetector_tpu/models/registry.py that the detection entry points use
(friendly-name resolution, the canonical model table with its thresholds,
the output-file metadata, a model file's version from its embedded
metadata or its name, embedding metadata in a model file, where
converted checkpoints are looked up, and download_model /
try_download_known_detector, which fetch an original checkpoint through
utils/url_utils.download_url with the MD5 check; a known name still
resolves to a converted checkpoint on disk first).

One difference on purpose: download_model(force_download=True) fetches
the file again even where it is on disk; the JAX function hands the
existing file to download_url, which skips it.
"""

import json
import os
import shutil
import tempfile
import zipfile

#%% Friendly-name resolution
#
# Maps the many ways users spell a model name to a canonical version string

model_string_to_model_version = {

    'mdv2': 'v2.0.0',
    'mdv3': 'v3.0.0',
    'mdv4': 'v4.1.0',
    'mdv5a': 'v5a.0.1',
    'mdv5b': 'v5b.0.1',

    'v2': 'v2.0.0',
    'v3': 'v3.0.0',
    'v4': 'v4.1.0',
    'v4.1': 'v4.1.0',
    'v5a.0.0': 'v5a.0.1',
    'v5b.0.0': 'v5b.0.1',
    'v5a.0.1': 'v5a.0.1',
    'v5b.0.1': 'v5b.0.1',

    'md1000-redwood': 'v1000.0.0-redwood',
    'md1000-cedar': 'v1000.0.0-cedar',
    'md1000-larch': 'v1000.0.0-larch',
    'md1000-sorrel': 'v1000.0.0-sorrel',
    'md1000-spruce': 'v1000.0.0-spruce',

    'mdv1000-redwood': 'v1000.0.0-redwood',
    'mdv1000-cedar': 'v1000.0.0-cedar',
    'mdv1000-larch': 'v1000.0.0-larch',
    'mdv1000-sorrel': 'v1000.0.0-sorrel',
    'mdv1000-spruce': 'v1000.0.0-spruce',

    'v1000-redwood': 'v1000.0.0-redwood',
    'v1000-cedar': 'v1000.0.0-cedar',
    'v1000-larch': 'v1000.0.0-larch',
    'v1000-sorrel': 'v1000.0.0-sorrel',
    'v1000-spruce': 'v1000.0.0-spruce',

    'redwood': 'v1000.0.0-redwood',
    'spruce': 'v1000.0.0-spruce',
    'cedar': 'v1000.0.0-cedar',
    'larch': 'v1000.0.0-larch',

    'mdv5': 'v5a.0.1',
    'md5': 'v5a.0.1',
    'mdv1000': 'v1000.0.0-redwood',
    'md1000': 'v1000.0.0-redwood',
    'default': 'v5a.0.1',
    'megadetector': 'v5a.0.1',
}

model_url_base = 'https://github.com/agentmorris/MegaDetector/releases/download/v1000.0/'

if os.environ.get('MD_MODEL_URL_BASE') is not None:
    model_url_base = os.environ['MD_MODEL_URL_BASE']
    if not model_url_base.endswith('/'):
        model_url_base += '/'


#%% Canonical model table
#
# 'model_type' values:
#   'yolov5'      anchor-based YOLOv5-family layout ([B, A, 5+nc])
#   'ultralytics' anchor-free ultralytics/yolov9 layout ([B, 4+nc, A])
#   'tf'          legacy TF frozen-graph models (MDv2-v4)

known_models = {
    'v2.0.0': {
        'url': 'https://lila.science/public/models/megadetector/megadetector_v2.pb',
        'typical_detection_threshold': 0.8,
        'conservative_detection_threshold': 0.3,
        'model_type': 'tf',
        'normalized_typical_inference_speed': 1.0 / 3.5,
    },
    'v3.0.0': {
        'url': 'https://lila.science/public/models/megadetector/megadetector_v3.pb',
        'typical_detection_threshold': 0.8,
        'conservative_detection_threshold': 0.3,
        'model_type': 'tf',
        'normalized_typical_inference_speed': 1.0 / 3.5,
    },
    'v4.1.0': {
        'url': 'https://github.com/agentmorris/MegaDetector/releases/download/v4.1/md_v4.1.0.pb',
        'typical_detection_threshold': 0.8,
        'conservative_detection_threshold': 0.3,
        'model_type': 'tf',
        'normalized_typical_inference_speed': 1.0 / 3.5,
    },
    'v5a.0.0': {
        'url': 'https://github.com/agentmorris/MegaDetector/releases/download/v5.0/md_v5a.0.0.pt',
        'typical_detection_threshold': 0.2,
        'conservative_detection_threshold': 0.05,
        'image_size': 1280,
        'model_type': 'yolov5',
        'arch': 'yolov5l6',
        'normalized_typical_inference_speed': 1.0,
        'md5': 'ec1d7603ec8cf642d6e0cd008ba2be8c',
    },
    'v5b.0.0': {
        'url': 'https://github.com/agentmorris/MegaDetector/releases/download/v5.0/md_v5b.0.0.pt',
        'typical_detection_threshold': 0.2,
        'conservative_detection_threshold': 0.05,
        'image_size': 1280,
        'model_type': 'yolov5',
        'arch': 'yolov5l6',
        'normalized_typical_inference_speed': 1.0,
        'md5': 'bc235e73f53c5c95e66ea0d1b2cbf542',
    },
    'v5a.0.1': {
        'url': 'https://github.com/agentmorris/MegaDetector/releases/download/v5.0/md_v5a.0.1.pt',
        'typical_detection_threshold': 0.2,
        'conservative_detection_threshold': 0.05,
        'image_size': 1280,
        'model_type': 'yolov5',
        'arch': 'yolov5l6',
        'normalized_typical_inference_speed': 1.0,
        'md5': '60f8e7ec1308554df258ed1f4040bc4f',
    },
    'v5b.0.1': {
        'url': 'https://github.com/agentmorris/MegaDetector/releases/download/v5.0/md_v5b.0.1.pt',
        'typical_detection_threshold': 0.2,
        'conservative_detection_threshold': 0.05,
        'image_size': 1280,
        'model_type': 'yolov5',
        'arch': 'yolov5l6',
        'normalized_typical_inference_speed': 1.0,
        'md5': 'f17ed6fedfac2e403606a08c89984905',
    },
    'v1000.0.0-redwood': {
        'url': model_url_base + 'md_v1000.0.0-redwood.pt',
        'normalized_typical_inference_speed': 1.0,
        'md5': '74474b3aec9cf1a990da38b37ddf9197',
        'typical_detection_threshold': 0.3,
        'model_type': 'ultralytics',
    },
    'v1000.0.0-spruce': {
        'url': model_url_base + 'md_v1000.0.0-spruce.pt',
        'normalized_typical_inference_speed': 12.7,
        'md5': '1c9d1d2b3ba54931881471fdd508e6f2',
        'model_type': 'ultralytics',
    },
    'v1000.0.0-larch': {
        'url': model_url_base + 'md_v1000.0.0-larch.pt',
        'normalized_typical_inference_speed': 2.4,
        'md5': 'cab94ebd190c2278e12fb70ffd548b6d',
        'model_type': 'ultralytics',
    },
    'v1000.0.0-cedar': {
        'url': model_url_base + 'md_v1000.0.0-cedar.pt',
        'normalized_typical_inference_speed': 2.0,
        'md5': '3d6472c9b95ba687b59ebe255f7c576b',
        'model_type': 'ultralytics',
    },
    'v1000.0.0-sorrel': {
        'url': model_url_base + 'md_v1000.0.0-sorrel.pt',
        'normalized_typical_inference_speed': 7.0,
        'md5': '4339a2c8af7a381f18ded7ac2a4df03e',
        'model_type': 'ultralytics',
    },
}

DEFAULT_RENDERING_CONFIDENCE_THRESHOLD = \
    known_models['v5a.0.0']['typical_detection_threshold']
DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD = 0.005


#%% Version sniffing and metadata


def get_detector_metadata_from_version_string(detector_version):
    """
    Metadata dict for a canonical version string, used to populate the
    'detector_metadata' field of MD output files.
    """

    if detector_version not in known_models:
        return {
            'megadetector_version': 'unknown',
            'typical_detection_threshold': 0.2,
            'conservative_detection_threshold': 0.1,
        }
    to_return = dict(known_models[detector_version])
    to_return['megadetector_version'] = detector_version
    return to_return


def get_detector_version_from_filename(detector_filename,
                                       accept_first_match=True,
                                       verbose=False):
    """
    Canonical version string implied by a model filename
    (e.g. 'md_v5a.0.0.pt' -> 'v5a.0.1'); 'unknown' when nothing matches,
    'multiple' when ambiguous and accept_first_match is False.
    """

    fn = os.path.basename(detector_filename).lower()
    matches = [s for s in model_string_to_model_version if s in fn]
    if len(matches) == 0:
        return 'unknown'
    if len(matches) > 1 and not accept_first_match:
        return 'multiple'
    return model_string_to_model_version[matches[0]]


def get_detector_version_from_model_file(detector_filename, verbose=False):
    """
    Canonical version string for a model file: prefers embedded metadata
    (converted-checkpoint metadata.json or a megadetector_info.json inside a
    .pt zip), falling back to the filename; None when neither names one.
    """

    from_filename = get_detector_version_from_filename(detector_filename)
    if from_filename == 'unknown':
        from_filename = None

    from_file = None
    metadata = read_metadata_from_model_file(detector_filename,
                                             verbose=verbose)
    if isinstance(metadata, dict):
        v = metadata.get('model_version_string', None)
        if isinstance(v, str):
            from_file = v

    if from_file is not None:
        return from_file
    return from_filename


def read_metadata_from_model_file(detector_filename, verbose=False):
    """
    Read embedded model metadata: the metadata.json of a converted
    checkpoint (in its folder, or the .npz's sidecar), or the
    megadetector_info.json inside a .pt zipfile. Returns a dict or None.
    """

    try:
        if os.path.isdir(detector_filename):
            meta_file = os.path.join(detector_filename, 'metadata.json')
            if os.path.isfile(meta_file):
                with open(meta_file, 'r') as f:
                    return json.load(f)
            return None
        if detector_filename.endswith('.npz'):
            meta_file = os.path.splitext(detector_filename)[0] + \
                '.metadata.json'
            if os.path.isfile(meta_file):
                with open(meta_file, 'r') as f:
                    return json.load(f)
            return None
        if detector_filename.endswith(('.pt', '.zip')):
            if not zipfile.is_zipfile(detector_filename):
                return None
            with zipfile.ZipFile(detector_filename, 'r') as zf:
                names = [n for n in zf.namelist()
                         if n.endswith('megadetector_info.json')]
                if len(names) != 1:
                    return None
                with zf.open(names[0]) as f:
                    return json.loads(f.read().decode('utf-8'))
    except Exception:
        if verbose:
            import traceback
            traceback.print_exc()
    return None


def add_metadata_to_model_file(model_filename, metadata,
                               output_filename=None):
    """
    Embed model metadata: for a converted checkpoint (.npz or folder),
    merged into its metadata.json sidecar; for a reference .pt zipfile, a
    megadetector_info.json added inside the archive (written to
    [output_filename], a copy, when given). Returns the filename written.
    """

    if not isinstance(metadata, dict):
        raise TypeError('metadata must be a dict')
    metadata = dict(metadata)
    metadata.setdefault('metadata_format_version', 1.0)

    if model_filename.endswith('.npz') or os.path.isdir(model_filename):
        if os.path.isdir(model_filename):
            meta_file = os.path.join(model_filename, 'metadata.json')
        else:
            meta_file = os.path.splitext(model_filename)[0] + \
                '.metadata.json'
        existing = {}
        if os.path.isfile(meta_file):
            with open(meta_file) as f:
                existing = json.load(f)
        existing.update(metadata)
        with open(meta_file, 'w') as f:
            json.dump(existing, f, indent=1)
        return model_filename

    if not model_filename.endswith(('.pt', '.zip')):
        raise ValueError('Unsupported model file {}'.format(model_filename))
    if output_filename is None:
        output_filename = model_filename
    if output_filename != model_filename:
        shutil.copyfile(model_filename, output_filename)
    with zipfile.ZipFile(output_filename, 'a') as zf:
        if any(n.endswith('megadetector_info.json') for n in zf.namelist()):
            raise ValueError('Model file already contains metadata')
        root = zf.namelist()[0].split('/')[0] if zf.namelist() else ''
        arcname = (root + '/' if root else '') + 'megadetector_info.json'
        zf.writestr(arcname, json.dumps(metadata, indent=1))
    return output_filename


#%% Download and converted checkpoints


def get_default_model_folder():
    """Folder where downloaded and converted models are cached
    ($MD_MODEL_FOLDER)."""

    folder = os.environ.get(
        'MD_MODEL_FOLDER',
        os.path.join(tempfile.gettempdir(), 'megadetector_tpu_models'))
    os.makedirs(folder, exist_ok=True)
    return folder


def _validate_md5(filename, expected_md5):
    """True if [filename]'s MD5 matches [expected_md5]."""

    import hashlib
    h = hashlib.md5()
    with open(filename, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest().lower() == expected_md5.lower()


def download_model(model_version, force_download=False, model_folder=None):
    """
    Download (with MD5 validation and corrupted-file redownload) the original
    checkpoint for a canonical model version. Returns the local path.
    """

    from megadetector_tpu_torch.utils.url_utils import download_url

    assert model_version in known_models, \
        'Unknown model version {}'.format(model_version)
    entry = known_models[model_version]
    url = entry['url']
    if model_folder is None:
        model_folder = get_default_model_folder()
    local_file = os.path.join(model_folder, url.split('/')[-1])

    needs_download = force_download or not os.path.isfile(local_file)
    if not needs_download and 'md5' in entry:
        if not _validate_md5(local_file, entry['md5']):
            print('MD5 mismatch for {}, re-downloading'.format(local_file))
            os.remove(local_file)
            needs_download = True

    if needs_download:
        download_url(url, local_file, force_download=force_download,
                     verbose=True)
        if 'md5' in entry and not _validate_md5(local_file, entry['md5']):
            raise IOError(
                'Downloaded file {} failed MD5 validation'.format(local_file))

    return local_file


def try_download_known_detector(detector_name, force_download=False,
                                verbose=False):
    """
    If [detector_name] is a known model name (e.g. 'MDV5A'), return its
    converted checkpoint when one is on disk, else download the original
    (or find the cached copy) and return the local path; otherwise return
    [detector_name] unchanged.
    """

    if detector_name is None:
        return None

    # Environment-variable overrides, e.g. MDV5A=/path/to/model
    if detector_name in os.environ:
        detector_name = os.environ[detector_name]
        if verbose:
            print('Model name resolved via environment variable: {}'.format(
                detector_name))

    if os.path.exists(detector_name):
        return detector_name

    name_lower = detector_name.lower()
    if name_lower not in model_string_to_model_version:
        return detector_name
    version = model_string_to_model_version[name_lower]

    # Prefer an already-converted checkpoint in the model cache
    converted = find_converted_checkpoint(version)
    if converted is not None:
        return converted

    return download_model(version, force_download=force_download)


def find_converted_checkpoint(model_version, model_folder=None):
    """
    Look for a converted checkpoint (.npz + metadata) for a model
    version in the model cache; returns the path or None.
    """

    if model_folder is None:
        model_folder = get_default_model_folder()
    candidates = [
        os.path.join(model_folder, 'md_{}.npz'.format(model_version)),
        os.path.join(model_folder, 'md_{}'.format(model_version)),
    ]
    for c in candidates:
        if os.path.exists(c):
            return c
    return None
