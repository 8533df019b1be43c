"""
The port's SpeciesNet bundle converter (megadetector_tpu_torch/models/
convert_speciesnet.py) against the JAX package's on a synthetic bundle
with the release layout (weights .pt + labels.txt + taxonomy_release.txt
+ geofence_base.json), built as tests/test_convert_speciesnet.py builds
one: classifier.npz, its metadata, taxonomy.txt, geofence.json and
conversion.json identical to JAX's, the bundle checks and the restricted
unpickler, and the artifact classifying through the port's
SpeciesClassifier as the torch reference computes.
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

from megadetector_tpu.models import convert_speciesnet as jcs
from megadetector_tpu_torch.models import convert_speciesnet as tcs

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

LABELS = [
    'aaaa0001-0000-0000-0000-000000000001;mammalia;rodentia;muridae;'
    'mus;musculus;house mouse',
    'aaaa0001-0000-0000-0000-000000000002;mammalia;carnivora;felidae;'
    'lynx;rufus;bobcat',
    'aaaa0001-0000-0000-0000-000000000003;aves;;;;;bird',
    'f1856211-cfb7-4a5b-9158-c0f72fd09ee6;;;;;;blank',
]


@pytest.fixture(scope='module')
def bundle(tmp_path_factory):
    from torch_effnet_ref import make_torch_effnet

    folder = tmp_path_factory.mktemp('sn_bundle')
    model = make_torch_effnet('efficientnetv2_test',
                              num_classes=len(LABELS), seed=0)
    torch.save({'state_dict': model.state_dict()},
               str(folder / 'always_crop_v4.pt'))
    (folder / 'labels.txt').write_text('\n'.join(LABELS) + '\n')
    (folder / 'taxonomy_release.txt').write_text('\n'.join(LABELS) + '\n')
    geofence = {LABELS[1]: {'allow': {'USA': []}}}
    (folder / 'geofence_base.json').write_text(json.dumps(geofence))
    return str(folder)


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_converted_files_identical_to_jax(bundle, tmp_path):
    jout, tout = str(tmp_path / 'jax'), str(tmp_path / 'port')
    jrep = jcs.convert_speciesnet_bundle(
        bundle, jout, arch='efficientnetv2_test', image_size=64,
        verbose=False)
    trep = tcs.convert_speciesnet_bundle(
        bundle, tout, arch='efficientnetv2_test', image_size=64,
        verbose=False)
    want, got = _npz(jrep['classifier']), _npz(trep['classifier'])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), k
    for name in ('classifier.metadata.json', 'taxonomy.txt',
                 'geofence.json'):
        with open(os.path.join(jout, name), 'rb') as a, \
                open(os.path.join(tout, name), 'rb') as b:
            assert a.read() == b.read(), name
    with open(os.path.join(jout, 'conversion.json')) as a, \
            open(os.path.join(tout, 'conversion.json')) as b:
        ja, tb = json.load(a), json.load(b)
    for key in ('classifier', 'taxonomy', 'geofence'):
        assert os.path.relpath(tb.pop(key), tout) == \
            os.path.relpath(ja.pop(key), jout)
    assert tb == ja == {k: v for k, v in trep.items() if k not in (
        'classifier', 'taxonomy', 'geofence')}


def test_bundle_checks_as_jax(bundle, tmp_path):
    assert tcs.find_bundle_files(bundle) == jcs.find_bundle_files(bundle)
    report = tcs.convert_speciesnet_bundle(bundle, None, dry_run=True,
                                           verbose=False)
    assert report == jcs.convert_speciesnet_bundle(bundle, None,
                                                   dry_run=True,
                                                   verbose=False)
    assert report['dry_run'] and report['num_classes'] == len(LABELS)
    bad = tmp_path / 'bad'
    bad.mkdir()
    (bad / 'labels.txt').write_text('not-a-taxonomy-string\n')
    (bad / 'model.pt').write_bytes(b'x')
    with pytest.raises(ValueError, match='taxonomy'):
        tcs.convert_speciesnet_bundle(str(bad), None, dry_run=True,
                                      verbose=False)
    (bad / 'labels.txt').unlink()
    with pytest.raises(ValueError, match='labels'):
        tcs.convert_speciesnet_bundle(str(bad), None, dry_run=True,
                                      verbose=False)
    labels = tmp_path / 'indexed.txt'
    labels.write_text('\n'.join('{},{}'.format(i, s)
                                for i, s in enumerate(LABELS)) + '\n#x\n')
    assert tcs.parse_labels_file(str(labels)) == \
        jcs.parse_labels_file(str(labels)) == LABELS


def test_restricted_unpickler_as_jax(tmp_path):
    """A training-args object that weights_only refuses loads through
    the restricted unpickler, whose stubs replace every class outside
    torch, numpy and the stdlib containers (no os.system)."""

    from torch_effnet_ref import make_torch_effnet

    state = make_torch_effnet('efficientnetv2_test', num_classes=4,
                              seed=1).state_dict()
    path = str(tmp_path / 'with_args.pth')
    torch.save({'model_state_dict': state,
                'args': argparse.Namespace(lr=0.1)}, path)
    got = tcs.load_torch_state_dict(path)
    want = jcs.load_torch_state_dict(path)
    assert list(got) == list(want) == list(state)
    for k in state:
        assert torch.equal(got[k], want[k])
    stub = tcs._restricted_torch_load(path)['args']
    assert type(stub).__name__ == 'Namespace' and \
        type(stub).__module__ == 'argparse'


def test_artifact_classifies_as_the_torch_reference(bundle, tmp_path):
    from torch_effnet_ref import make_torch_effnet

    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.models.classifier import SpeciesClassifier
    from megadetector_tpu_torch.models.convert_weights import \
        load_checkpoint

    report = tcs.convert_speciesnet_bundle(
        bundle, str(tmp_path / 'out'), arch='efficientnetv2_test',
        image_size=64, verbose=False)
    params, metadata = load_checkpoint(report['classifier'])
    assert metadata['class_names'] == LABELS
    config = efficientnet.EfficientNetConfig('efficientnetv2_test',
                                             num_classes=len(LABELS))
    x = np.random.RandomState(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    model = efficientnet.EfficientNet(config).load_params(params).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    ref = make_torch_effnet('efficientnetv2_test', num_classes=len(LABELS),
                            seed=0)
    with torch.no_grad():
        want = ref(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    clf = SpeciesClassifier(report['classifier'], {'image_size': 64},
                            device='cpu')
    assert clf.class_names == LABELS and clf.crop_mode == 'stretch'
    probs = clf.classify_batch([np.random.RandomState(1).randint(
        0, 255, (80, 60, 3), dtype=np.uint8)])
    assert probs.shape == (1, len(LABELS))
    assert abs(float(probs.sum()) - 1.0) < 1e-5


def test_cli_dry_run_and_conversion(bundle, tmp_path, monkeypatch, capsys):
    """The CLI's --dry_run takes no output_dir; the JAX converter's
    verbose dry run then joins None into a path and raises TypeError (a
    fault of the reference), the port's prints the layout check."""

    out = str(tmp_path / 'cli')
    monkeypatch.setattr(sys, 'argv', ['convert_speciesnet', bundle,
                                      '--dry_run'])
    with pytest.raises(TypeError):
        jcs.main()
    assert tcs.main() == 0
    assert 'dry run' in capsys.readouterr().out
    assert not os.path.exists(out)
    monkeypatch.setattr(sys, 'argv', ['convert_speciesnet', bundle, out,
                                      '--arch', 'efficientnetv2_test',
                                      '--image_size', '64'])
    assert tcs.main() == 0
    assert os.path.isfile(os.path.join(out, 'classifier.npz'))
