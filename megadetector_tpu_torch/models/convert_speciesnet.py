"""
The port's copy of megadetector_tpu/models/convert_speciesnet.py (no
device code), on the port's efficientnet and checkpoint writer: its
outputs are the JAX converter's, byte for byte.

Convert a SpeciesNet classifier release bundle into this framework's
classifier artifact, ready for detection/run_md_and_classifier (and its
run_md_and_speciesnet compatibility shim).

The reference delegates classification to the `speciesnet` package,
which downloads a Kaggle/HF release (e.g.
kaggle:google/speciesnet/pyTorch/v4.0.x, see
megadetector/detection/run_md_and_speciesnet.py:47-65,125). A release
bundle contains:

    <model>.pt / .pth      torch weights for the always-crop classifier
                           (EfficientNetV2-M; torchvision layout or a
                           plain state dict under common wrapper keys)
    labels.txt             one class per line; 7-token semicolon
                           taxonomy strings
                           uuid;class;order;family;genus;species;common
    taxonomy_release.txt   full taxonomy rows (same string format)
    geofence_base.json     {taxonomy_string: {'allow'/'block': {...}}}
    info/config json       metadata (input size etc.), optional

This converter is the day-one gate for real weights (egress currently
blocks downloading a bundle; everything here is tested against a
synthetic bundle with the same layout — tests/test_convert_speciesnet.py):

    python -m megadetector_tpu_torch.models.convert_speciesnet <bundle_dir> \
        out_dir [--arch efficientnetv2_m] [--image_size 480] [--dry_run]

Outputs, in out_dir:
    classifier.npz    converted weights + metadata (class_names carry
                      the full taxonomy strings, so the ensemble stage
                      recognizes them via is_taxonomy_string)
    taxonomy.txt      copied taxonomy rows (for --taxonomy_file)
    geofence.json     copied geofence table (for --geofence_file)
    conversion.json   provenance report (sources, counts, sha256s)

Then:
    python -m megadetector_tpu_torch.detection.run_md_and_classifier \
        images out.json --detector_model md.npz \
        --classifier_model out_dir/classifier.npz --apply_ensemble \
        --taxonomy_file out_dir/taxonomy.txt \
        --geofence_file out_dir/geofence.json
"""

import argparse
import hashlib
import json
import os
import shutil
import sys


BUNDLE_WEIGHT_EXTS = ('.pt', '.pth', '.bin')
STATE_DICT_WRAPPER_KEYS = ('state_dict', 'model_state_dict', 'model',
                           'net')


def find_bundle_files(bundle):
    """Locate the release files in a bundle directory (or accept a
    direct weight-file path, in which case siblings are searched).

    Returns dict with 'weights', 'labels', 'taxonomy', 'geofence'
    (absent optional entries are None).
    """

    if os.path.isfile(bundle):
        folder = os.path.dirname(os.path.abspath(bundle)) or '.'
        weights = bundle
    else:
        folder = bundle
        weights = None
        candidates = []
        for root, _dirs, files in os.walk(folder):
            for f in files:
                if f.lower().endswith(BUNDLE_WEIGHT_EXTS):
                    candidates.append(os.path.join(root, f))
        if len(candidates) == 1:
            weights = candidates[0]
        elif len(candidates) > 1:
            # Prefer an always-crop-named file, then the largest
            ac = [c for c in candidates if 'crop' in
                  os.path.basename(c).lower()]
            pool = ac if ac else candidates
            weights = max(pool, key=os.path.getsize)

    def find_one(names):
        for root, _dirs, files in os.walk(folder):
            lower = {f.lower(): f for f in files}
            for n in names:
                if n in lower:
                    return os.path.join(root, lower[n])
        return None

    return {
        'weights': weights,
        'labels': find_one(['labels.txt', 'labels.csv']),
        'taxonomy': find_one(['taxonomy_release.txt', 'taxonomy.txt']),
        'geofence': find_one(['geofence_base.json',
                              'geofence_release.json', 'geofence.json']),
    }


def parse_labels_file(path):
    """Parse labels.txt: one taxonomy string per line, line order =
    class index. Validates the 7-token semicolon format used by
    SpeciesNet (postprocessing/classification_ensemble.py documents the
    token layout)."""

    from megadetector_tpu_torch.postprocessing.classification_ensemble \
        import is_taxonomy_string

    labels = []
    bad = []
    with open(path, 'r', encoding='utf-8') as f:
        for line_number, line in enumerate(f):
            s = line.strip()
            if not s or s.startswith('#'):
                continue
            # Tolerate an index prefix ("0,uuid;..." or "0 uuid;...")
            if ';' in s and ',' in s.split(';')[0]:
                s = s.split(',', 1)[1]
            if not is_taxonomy_string(s):
                bad.append((line_number + 1, s))
            labels.append(s)
    if not labels:
        raise ValueError('No labels found in {}'.format(path))
    if bad:
        raise ValueError(
            '{} label line(s) are not 7-token semicolon taxonomy '
            'strings, e.g. line {}: {!r}'.format(
                len(bad), bad[0][0], bad[0][1][:120]))
    return labels


def _sha256(path):
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest()


#: Pickle GLOBAL opcodes resolving outside these module prefixes are
#: replaced with inert stubs by the restricted fallback loader below —
#: a malicious bundle cannot resolve (and therefore cannot REDUCE-call)
#: arbitrary importables like os.system
_SAFE_PICKLE_MODULE_PREFIXES = (
    'torch', 'collections', 'numpy', '_codecs', 'builtins')


def _restricted_torch_load(path):
    """torch.load for release bundles whose pickles reference classes
    weights_only=True rejects (e.g. argparse.Namespace training args):
    classes from torch/numpy/stdlib-container modules resolve normally,
    everything else becomes an inert stub — never an arbitrary
    importable, so untrusted bundles cannot execute code through the
    unpickler (same posture as convert_weights.extract_torch_state_dict,
    hardened from stub-on-failure to stub-on-unknown)."""

    import pickle
    import io
    import torch
    from megadetector_tpu_torch.models.convert_weights import \
        _make_stub_class

    class _RestrictedUnpickler(pickle.Unpickler):

        def find_class(self, module, name):
            root = module.split('.', 1)[0]
            if root in _SAFE_PICKLE_MODULE_PREFIXES:
                try:
                    return super().find_class(module, name)
                except (ImportError, AttributeError):
                    pass
            return _make_stub_class(module, name)

    shim = type(pickle)('speciesnet_restricted_pickle')
    shim.Unpickler = _RestrictedUnpickler
    shim.load = lambda f, **kw: _RestrictedUnpickler(f).load()
    shim.loads = lambda b, **kw: _RestrictedUnpickler(
        io.BytesIO(b)).load()
    return torch.load(path, map_location='cpu', pickle_module=shim,
                      weights_only=False)


def load_torch_state_dict(path):
    """Load the weight file into a flat {name: tensor} state dict,
    unwrapping the common wrapper keys. torchscript archives are
    rejected with conversion instructions (their parameter names are
    not stable across script versions)."""

    import torch

    try:
        blob = torch.load(path, map_location='cpu', weights_only=True)
    except Exception:
        try:
            blob = _restricted_torch_load(path)
        except RuntimeError as e:
            if 'torchscript' in str(e).lower() or \
                    'constants.pkl' in str(e).lower():
                raise ValueError(
                    '{} looks like a torchscript archive; extract a '
                    'state dict first: '
                    'torch.jit.load(p).state_dict() -> torch.save'
                    .format(path))
            raise
    if hasattr(blob, 'state_dict'):
        blob = blob.state_dict()
    if isinstance(blob, dict):
        for key in STATE_DICT_WRAPPER_KEYS:
            inner = blob.get(key)
            if isinstance(inner, dict) and inner and \
                    all(hasattr(v, 'shape') for v in inner.values()):
                blob = inner
                break
            if hasattr(inner, 'state_dict'):
                blob = inner.state_dict()
                break
    if not isinstance(blob, dict) or not blob:
        raise ValueError('Unrecognized weight file structure in {}'
                         .format(path))
    return {k: v for k, v in blob.items() if hasattr(v, 'shape')}


def convert_speciesnet_bundle(bundle, output_dir,
                              arch='efficientnetv2_m', image_size=480,
                              dry_run=False, verbose=True):
    """Convert a SpeciesNet release bundle; returns the report dict.

    dry_run validates the bundle layout, labels format, and (when the
    weight file is loadable) the tensor inventory, without writing
    anything.
    """

    files = find_bundle_files(bundle)
    if files['weights'] is None:
        raise ValueError('No weight file (*.pt/*.pth) found in {}'
                         .format(bundle))
    if files['labels'] is None:
        raise ValueError('No labels.txt found in {}'.format(bundle))

    labels = parse_labels_file(files['labels'])
    report = {
        'bundle': os.path.abspath(bundle),
        'files': {k: (os.path.abspath(v) if v else None)
                  for k, v in files.items()},
        'num_classes': len(labels),
        'arch': arch,
        'image_size': image_size,
    }
    if verbose:
        print('bundle files:')
        for k, v in files.items():
            print('  {:9s}: {}'.format(k, v))
        print('labels: {} classes ({} ... {})'.format(
            len(labels), labels[0].split(';')[-1],
            labels[-1].split(';')[-1]))

    if dry_run:
        report['dry_run'] = True
        if verbose:
            # The CLI takes --dry_run without an output_dir (the JAX
            # converter joins None there and raises TypeError)
            print('dry run: bundle layout OK; would write {}'.format(
                os.path.join(output_dir or '<output_dir>',
                             'classifier.npz')))
        return report

    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.models.convert_weights import \
        save_checkpoint

    state_dict = load_torch_state_dict(files['weights'])
    config = efficientnet.EfficientNetConfig(
        arch, num_classes=len(labels))
    params = efficientnet.convert_torchvision_state_dict(
        state_dict, config)

    os.makedirs(output_dir, exist_ok=True)
    out_npz = os.path.join(output_dir, 'classifier.npz')
    metadata = {
        'arch': arch,
        'model_type': 'speciesnet',
        'num_classes': len(labels),
        'class_names': labels,
        'image_size': image_size,
        # SpeciesNet preprocessing: [0,1] scaling, stretch-resize crops
        'normalization_mean': [0.0, 0.0, 0.0],
        'normalization_std': [1.0, 1.0, 1.0],
        'crop_mode': 'stretch',
        'source_weights_sha256': _sha256(files['weights']),
    }
    save_checkpoint(params, out_npz, metadata)
    report['classifier'] = out_npz

    for key, out_name in (('taxonomy', 'taxonomy.txt'),
                          ('geofence', 'geofence.json')):
        if files[key] is not None:
            dst = os.path.join(output_dir, out_name)
            shutil.copyfile(files[key], dst)
            report[key] = dst

    report_path = os.path.join(output_dir, 'conversion.json')
    with open(report_path, 'w', encoding='utf-8') as f:
        json.dump(report, f, indent=1)
    if verbose:
        print('wrote {}'.format(out_npz))
    return report


def main():
    parser = argparse.ArgumentParser(
        description='Convert a SpeciesNet release bundle to a '
                    'classifier artifact')
    parser.add_argument('bundle',
                        help='bundle directory (or weight file path)')
    parser.add_argument('output_dir', nargs='?', default=None,
                        help='output directory (required unless '
                             '--dry_run)')
    parser.add_argument('--arch', default='efficientnetv2_m')
    parser.add_argument('--image_size', type=int, default=480)
    parser.add_argument('--dry_run', action='store_true',
                        help='validate the bundle without converting')
    args = parser.parse_args()
    if not args.dry_run and args.output_dir is None:
        parser.error('output_dir is required unless --dry_run')
    convert_speciesnet_bundle(
        args.bundle, args.output_dir, arch=args.arch,
        image_size=args.image_size, dry_run=args.dry_run)
    return 0


if __name__ == '__main__':
    sys.exit(main())
