"""
Data parallelism in the port's inference paths, on CPU meshes
(parallel/mesh.make_data_mesh(devices=['cpu'] * n), the counterpart of the
JAX package's virtual CPU devices):

- the mesh helpers against megadetector_tpu/parallel/mesh.py's;
- the meshed detector against the unsharded one on meshes of 1, 2 and 4
  replicas: run_program's outputs and the MD records identical (every
  image's program is its own on the CPU, whatever its shard), in host and
  device preprocessing and under augment; escalation at the capacity the
  whole batch needs, on every shard; the option checks;
- the meshed detector against the JAX detector on a mesh of the 8
  virtual CPU devices that tests/conftest.py forces, at the golden
  tolerances (batches of 8: ROADMAP C on the JAX driver's tail bucket);
- the batch driver's and the server's auto-mesh with the card count
  patched to 2 and make_data_mesh standing in with a CPU mesh: they engage
  above one card only, round the batch size up and write the one-card
  JSON; an exported artifact takes no mesh.
"""

import json
import os

import numpy as np
import pytest
import torch

from PIL import Image

from megadetector_tpu.parallel import mesh as jax_mesh
from megadetector_tpu.utils import md_tests
from megadetector_tpu_torch.detection import run_detector, \
    run_detector_batch
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.models.detector import TorchDetector
from megadetector_tpu_torch.ops.boxes import letterbox
from megadetector_tpu_torch.parallel import mesh
from megadetector_tpu_torch.parallel.mesh import make_data_mesh

import torch_port_data as data


def _cpu_mesh(n):
    return make_data_mesh(devices=['cpu'] * n)


#%% The mesh helpers


def test_make_data_mesh_matches_jax():
    for n in (None, 1, 4, 8):
        ours = make_data_mesh(n, devices=['cpu'] * 8)
        ref = jax_mesh.make_data_mesh(n)
        assert ours.devices.size == ref.devices.size
        assert ours.devices.shape == ref.devices.shape
        assert ours.axis_names == ref.axis_names == ('data',)
        assert all(d == torch.device('cpu') for d in ours.devices.flat)
    assert make_data_mesh(2, 'batch', devices=['cpu'] * 3).axis_names == \
        jax_mesh.make_data_mesh(2, 'batch').axis_names
    with pytest.raises(AssertionError, match='Requested 9 devices but only '
                                             '8 available'):
        make_data_mesh(9, devices=['cpu'] * 8)
    with pytest.raises(AssertionError, match='Requested 9 devices but only '
                                             '8 available'):
        jax_mesh.make_data_mesh(9)


def test_make_data_mesh_takes_the_local_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 3)
    m = make_data_mesh()
    assert [str(d) for d in m.devices.flat] == ['cuda:0', 'cuda:1',
                                                 'cuda:2']
    assert make_data_mesh(2).devices.size == 2
    assert mesh.local_device_count() == 3
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        make_data_mesh()
    assert mesh.local_device_count() == 0
    # 'cuda' names the current card, so that both names key one device
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    assert [str(d) for d in make_data_mesh(devices=[
        'cuda', 'cuda:0']).devices.flat] == ['cuda:0', 'cuda:0']


@pytest.mark.parametrize('n,multiple', [(5, 4), (8, 4), (1, 8), (3, 1),
                                        (7, 2)])
def test_pad_batch_to_multiple_matches_jax(n, multiple):
    rng = np.random.RandomState(n)
    arrays = [rng.randint(0, 255, (n, 4, 4, 3)).astype(np.uint8),
              rng.rand(n, 2).astype(np.float32)]
    ours, n_ours = mesh.pad_batch_to_multiple(arrays, multiple)
    ref, n_ref = jax_mesh.pad_batch_to_multiple(arrays, multiple)
    assert n_ours == n_ref == n
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_process_helpers_match_jax():
    assert mesh.process_index() == jax_mesh.process_index() == 0
    assert mesh.process_count() == jax_mesh.process_count() == 1
    files = ['f{}.jpg'.format(i) for i in range(7)]
    assert mesh.shard_image_list_for_hosts(files) == \
        jax_mesh.shard_image_list_for_hosts(files)
    for path, index in (('out/results.json', None), ('r.json', 3),
                        ('noext', 12)):
        assert mesh.shard_output_filename(path, index) == \
            jax_mesh.shard_output_filename(path, index)


def test_process_helpers_read_torch_distributed(tmp_path):
    """With a process group (gloo, one rank, a file store) the rank and
    world size come from it, as JAX's come from its processes."""

    import torch.distributed as dist
    dist.init_process_group('gloo', init_method='file://{}'.format(
        tmp_path / 'store'), rank=0, world_size=1)
    try:
        assert dist.is_initialized()
        assert mesh.process_index() == 0 and mesh.process_count() == 1
        assert mesh.shard_output_filename('a.json') == 'a.host000.json'
    finally:
        dist.destroy_process_group()


def test_shardings_name_the_mesh_and_axis():
    m = _cpu_mesh(2)
    assert mesh.batch_sharding(m) == (m, 'data')
    assert mesh.replicated_sharding(m) == (m, None)
    with pytest.raises(ValueError, match='no axis'):
        mesh.batch_sharding(m, 'model')
    assert 'cpu' in repr(m) and m.size == 2


#%% The meshed detector within the port


@pytest.fixture(scope='module')
def model_path(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_mesh')
    path = str(root / 'md_v5a.0.0_test.npz')
    save_checkpoint(data.sharpened_params(data.images()), path,
                    data.METADATA)
    return path


def _canvases(n=8):
    imgs = data.images()
    imgs = imgs + [im[::-1].copy() for im in imgs]
    return np.stack([letterbox(im, (256, 256), stride=32, auto=False)[0]
                     for im in imgs[:n]])


@pytest.fixture(scope='module')
def unsharded(model_path):
    detector = run_detector.load_detector(model_path, device='cpu')
    return detector, detector.run_program(_canvases(), 0.005, 0.45)


@pytest.mark.parametrize('n', [1, 2, 4])
def test_meshed_run_program_is_the_unsharded_one(model_path, unsharded, n):
    _, (ref, topk_ref) = unsharded
    detector = run_detector.load_detector(
        model_path, device='cpu', detector_options={'mesh': _cpu_mesh(n)})
    assert detector.mesh.devices.size == n
    out, topk = detector.run_program(_canvases(), 0.005, 0.45)
    assert topk == topk_ref
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype
        assert out[k].tobytes() == ref[k].tobytes(), k
    # One program a shard on every replica's own cache
    for r in detector._replicas:
        keys = [k for k in r.programs.entries if k[0] == 'forward' and
                'select' not in k]
        assert keys == [('forward', 8 // n, 256, 256, True)]
    assert detector._replicas[0].model is detector.model
    assert all(r.model is not detector.model
               for r in detector._replicas[1:])
    assert detector.programs_run == 1 and detector.host_reads == 2 * n


@pytest.mark.parametrize('n', [2, 4])
def test_meshed_run_program_pads_a_batch_that_does_not_split(
        model_path, unsharded, n):
    _, (ref, _) = unsharded
    detector = run_detector.load_detector(
        model_path, device='cpu', detector_options={'mesh': _cpu_mesh(n)})
    out, _ = detector.run_program(_canvases()[:5], 0.005, 0.45)
    assert all(out[k].tobytes() == ref[k][:5].tobytes() for k in ref)


@pytest.mark.parametrize('options', [
    {}, {'preprocess_mode': 'device'}, {'compatibility_mode': 'modern'},
    {'compatibility_mode': 'classic-strict'}])
@pytest.mark.parametrize('n', [1, 2, 4])
def test_meshed_records_are_the_unsharded_ones(model_path, options, n):
    imgs = data.images()
    ids = ['im{}'.format(i) for i in range(len(imgs))]
    base = run_detector.load_detector(model_path, device='cpu',
                                      detector_options=options)
    meshed = run_detector.load_detector(
        model_path, device='cpu',
        detector_options=dict(options, mesh=_cpu_mesh(n), batch_axis='data'))
    ref = base.generate_detections_one_batch(imgs, ids, 0.005)
    ours = meshed.generate_detections_one_batch(imgs, ids, 0.005)
    assert ours == ref
    assert any(r['detections'] for r in ref)


@pytest.mark.parametrize('n', [2, 4])
def test_meshed_augment_is_the_unsharded_one(model_path, n):
    imgs = data.images()[:4]
    ids = ['a', 'b', 'c', 'd']
    base = run_detector.load_detector(model_path, device='cpu')
    meshed = run_detector.load_detector(
        model_path, device='cpu', detector_options={'mesh': _cpu_mesh(n)})
    assert meshed.generate_detections_one_batch(
        imgs, ids, 0.005, augment=True) == base.generate_detections_one_batch(
            imgs, ids, 0.005, augment=True)
    x = _canvases(4)
    ref, _ = base.run_program(x, 0.005, 0.45, augment=True)
    out, _ = meshed.run_program(x, 0.005, 0.45, augment=True)
    # Each shard's outputs are the unsharded detector's on that shard, bit
    # for bit. On the CPU the TTA program at batch 1 rounds a few float32
    # scores and boxes otherwise than at batch 4 (up to 8.3e-7 and 3.1e-5
    # px measured; the records above are equal): so the whole batch's are
    # held at 1e-5 and 1e-3 px
    size = 4 // n
    shards = [base.run_program(x[i:i + size], 0.005, 0.45, augment=True)[0]
              for i in range(0, 4, size)]
    for k in ref:
        assert out[k].tobytes() == np.concatenate(
            [o[k] for o in shards]).tobytes(), k
    assert np.array_equal(out['valid'], ref['valid'])
    assert np.array_equal(out['classes'], ref['classes'])
    np.testing.assert_allclose(out['scores'], ref['scores'], atol=1e-5)
    np.testing.assert_allclose(out['boxes'], ref['boxes'], atol=1e-3)
    for r in meshed._replicas:
        assert {k[:2] for k in r.programs.entries} == {('augment', 4 // n)}


def test_escalation_takes_the_whole_batch_capacity_on_every_shard(
        model_path):
    """Shard 0's images need a capacity of 128, shard 1's (a gray canvas
    and a darker flipped one) only 64: both shards run at 128, as the
    unsharded batch does, and the outputs are the unsharded ones."""

    x = _canvases(2)
    gray = np.full_like(x[:1], 128)
    x = np.concatenate([x, gray, gray[:, :, ::-1] // 2])
    options = {'pre_nms_topk': 32}
    base = run_detector.load_detector(model_path, device='cpu',
                                      detector_options=options)
    ref, topk_ref = base.run_program(x, 0.005, 0.45)
    counts = ref['n_candidates']
    assert counts[:2].max() > 64 >= counts[2:].max() > 32
    meshed = run_detector.load_detector(
        model_path, device='cpu',
        detector_options=dict(options, mesh=_cpu_mesh(2)))
    out, topk = meshed.run_program(x, 0.005, 0.45)
    assert topk == topk_ref == 128
    assert all(out[k].tobytes() == ref[k].tobytes() for k in ref)
    for r in meshed._replicas:
        capacities = sorted(k[k.index('select') + 1]
                            for k in r.programs.entries if 'select' in k)
        assert capacities == [32, 128]


def test_mesh_options_are_checked(model_path):
    with pytest.raises(TypeError, match='DataMesh'):
        run_detector.load_detector(model_path, device='cpu',
                                   detector_options={'mesh': object()})
    with pytest.raises(ValueError, match='no mesh'):
        run_detector.load_detector(model_path, device='cpu',
                                   detector_options={'batch_axis': 'data'})
    with pytest.raises(ValueError, match='not an axis'):
        run_detector.load_detector(model_path, device='cpu',
                                   detector_options={'mesh': _cpu_mesh(2),
                                                     'batch_axis': 'model'})
    detector = run_detector.load_detector(model_path, device='cpu')
    assert detector.mesh is None and detector.supports_mesh
    detector.mesh = _cpu_mesh(2)
    assert len(detector._replicas) == 2
    detector.mesh = None
    assert detector._replicas is None
    with pytest.raises(TypeError):
        detector.mesh = 'cpu'


def test_int8_and_bf16_replicas_keep_the_loaded_model(tmp_path):
    """A chain-int8 checkpoint in bf16 with the fused stem: each replica is
    the loaded model (int8 scales, bf16 weights, the stem's weights and
    their version stamps), and the meshed outputs are the unsharded
    ones."""

    from megadetector_tpu_torch.models.convert_weights import \
        quantize_checkpoint
    imgs = data.images()
    float_path = str(tmp_path / 'f.npz')
    save_checkpoint(data.sharpened_params(imgs), float_path, data.METADATA)
    q_path = str(tmp_path / 'q.npz')
    calibration = [im[:192, :256] for im in imgs[:2]]
    quantize_checkpoint(float_path, q_path, calibration_images=calibration,
                        device='cpu')
    for options in ({'dtype': 'bf16'}, {'conv_backend': 'pallas'}):
        base = run_detector.load_detector(q_path, device='cpu',
                                          detector_options=options)
        meshed = run_detector.load_detector(
            q_path, device='cpu',
            detector_options=dict(options, mesh=_cpu_mesh(2)))
        for r in meshed._replicas[1:]:
            for (k, a), (_, b) in zip(r.model.state_dict().items(),
                                      base.model.state_dict().items()):
                assert a.dtype == b.dtype and torch.equal(a, b), k
        x = _canvases(4)
        ref, _ = base.run_program(x, 0.005, 0.45)
        out, _ = meshed.run_program(x, 0.005, 0.45)
        assert all(out[k].tobytes() == ref[k].tobytes() for k in ref)


def test_each_replica_captures_on_a_stream_of_its_own_card(
        model_path, monkeypatch):
    """A mesh over cuda:0 and cuda:1 (the model copies stay on the CPU,
    the CUDA calls are stand-ins): each replica's program cache captures
    its graphs on a stream of its replica's card, under that card, and
    never on torch.cuda.graph's one default capture stream, whose card is
    whichever captured first (a replica on another card would run
    eagerly beside an empty graph)."""

    import contextlib
    from megadetector_tpu_torch.parallel import replicas as replicas_lib

    class StandInStream:
        def __init__(self, device=None):
            self.device = torch.device(device)

    current = []
    captures = []

    @contextlib.contextmanager
    def stand_in_device(device):
        current.append(torch.device(device))
        yield
        current.pop()

    @contextlib.contextmanager
    def stand_in_graph(graph, pool=None, stream=None, **kwargs):
        captures.append((stream, current[-1]))
        yield

    monkeypatch.setattr(torch.cuda, 'Stream', StandInStream)
    monkeypatch.setattr(torch.cuda, 'device', stand_in_device)
    monkeypatch.setattr(torch.cuda, 'graph', stand_in_graph)
    monkeypatch.setattr(torch.cuda, 'graph_pool_handle', object)
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', object)
    monkeypatch.setattr(replicas_lib, 'replicate_module',
                        lambda module, device: module)
    detector = run_detector.load_detector(model_path, device='cpu')
    detector.mesh = make_data_mesh(devices=['cuda:0', 'cuda:1'])
    for r in detector._replicas:
        assert r.programs.device == r.device
        for _ in range(2):
            graph, outputs = r.programs.capturer.capture(lambda: (1,), ())
            assert outputs == (1,)
    assert [(s.device, d) for s, d in captures] == [
        (torch.device('cuda', i), torch.device('cuda', i))
        for i in (0, 0, 1, 1)]
    # One capture stream a cache, kept for its later captures
    assert captures[0][0] is captures[1][0]
    assert captures[2][0] is captures[3][0]
    assert captures[0][0] is not captures[2][0]


#%% Against the JAX detector on 8 virtual devices


def test_meshed_detector_matches_jax_on_8_devices(model_path):
    from megadetector_tpu.models.detector import TPUDetector
    imgs = data.images()
    imgs = imgs + [imgs[0][::-1].copy()]
    ids = ['im{}.png'.format(i) for i in range(len(imgs))]
    jax_detector = TPUDetector(model_path, detector_options={
        'mesh': jax_mesh.make_data_mesh(8), 'pad_batches_to': 8})
    ours = run_detector.load_detector(
        model_path, device='cpu',
        detector_options={'mesh': _cpu_mesh(8), 'pad_batches_to': 8})
    ref = jax_detector.generate_detections_one_batch(imgs, ids, 0.005)
    got = ours.generate_detections_one_batch(imgs, ids, 0.005)
    result = md_tests.compare_results({'images': ref}, {'images': got},
                                      data.golden_options())
    assert result['n_images_compared'] == len(imgs)
    assert result['errors'] == [], result['errors'][:5]
    assert any(r['detections'] for r in got)


#%% Auto-mesh in the batch driver and the server


@pytest.fixture
def two_cards(monkeypatch):
    """torch.cuda.device_count patched to 2 and make_data_mesh standing in
    with a CPU mesh of 2: what the drivers see on a two-card host, with
    CPU replicas."""

    made = []

    def fake_make_data_mesh(n_devices=None, axis_name='data', devices=None):
        made.append(n_devices)
        return make_data_mesh(n_devices, axis_name, devices=['cpu'] * 2)

    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    monkeypatch.setattr(mesh, 'make_data_mesh', fake_make_data_mesh)
    return made


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_mesh_images')
    for i, img in enumerate(data.images()):
        Image.fromarray(img).save(str(root / 'im{:02d}.png'.format(i)))
    return str(root)


def _driver_json(model_path, folder, out, options, batch_size=3):
    results = run_detector_batch.load_and_run_detector_batch(
        model_path, folder, batch_size=batch_size, quiet=True,
        detector_options=dict(options, force_cpu='true'))
    run_detector_batch.write_results_to_file(
        results, out, relative_path_base=folder, detector_file=model_path)
    with open(out) as f:
        return json.load(f)


def test_batch_driver_auto_meshes_above_one_card(model_path, folder,
                                                 tmp_path, two_cards,
                                                 capsys, monkeypatch):
    """Two cards: batch_size 3 rounds up to 4, batches split over the
    mesh, and the JSON is the one-card run's; use_mesh=false keeps one
    device; one card attaches nothing."""

    attached = []
    original = TorchDetector.attach_auto_mesh
    original_load = run_detector_batch.load_detector

    def recording_attach(detector, batch_size, *args, **kw):
        out = original(detector, batch_size, *args, **kw)
        attached.append((detector.mesh, detector.pad_batches_to, out))
        return out

    def recording_load(*args, **kw):
        detector = original_load(*args, **kw)
        loaded.append(detector)
        return detector

    loaded = []
    monkeypatch.setattr(TorchDetector, 'attach_auto_mesh', recording_attach)
    monkeypatch.setattr(run_detector_batch, 'load_detector', recording_load)
    meshed = _driver_json(model_path, folder, str(tmp_path / 'm.json'), {})
    mesh_used, padded, batch_size = attached[-1]
    assert mesh_used is not None and mesh_used.devices.size == 2
    assert padded == batch_size == 4 and two_cards == [None]
    plain = _driver_json(model_path, folder, str(tmp_path / 'p.json'),
                         {'use_mesh': 'false'})
    # use_mesh=false: the detector is never offered a mesh
    assert len(attached) == 1 and loaded[-1].mesh is None
    assert loaded[-1].pad_batches_to == 3
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    one = _driver_json(model_path, folder, str(tmp_path / 'o.json'), {})
    assert attached[-1][0] is None and attached[-1][2] == 3
    assert two_cards == [None]
    assert meshed['images'] == plain['images'] == one['images']


def test_auto_mesh_skips_detectors_it_cannot_mesh(model_path, two_cards,
                                                  monkeypatch):
    detector = run_detector.load_detector(model_path, device='cpu')
    detector.supports_mesh = False
    assert detector.attach_auto_mesh(3) == 3 and detector.mesh is None
    del detector.supports_mesh
    # A mesh of another device type than the detector's: left alone
    monkeypatch.setattr(mesh, 'make_data_mesh',
                        lambda *a, **k: make_data_mesh(
                            devices=[torch.device('meta')] * 2))
    assert detector.attach_auto_mesh(3) == 3 and detector.mesh is None
    # A detector that already has a mesh keeps it
    own = _cpu_mesh(3)
    detector.mesh = own
    assert detector.attach_auto_mesh(3) == 3 and detector.mesh is own


def test_server_auto_meshes_above_one_card(model_path, two_cards, capsys,
                                           monkeypatch):
    """The server rounds max_batch_size up to the card count and attaches
    the mesh (force_cpu is what keeps the JAX server unmeshed, so it is
    off here and the device is the CPU by option); its answers are the
    one-card server's."""

    from megadetector_tpu_torch.serving.server import MDServer, \
        ServingOptions

    def serve(device_count):
        monkeypatch.setattr(torch.cuda, 'device_count',
                            lambda: device_count)
        options = ServingOptions()
        options.port = 0
        options.device = 'cpu'
        options.max_batch_size = 3
        server = MDServer(model_path, options)
        try:
            detector = server.detector
            records = detector.generate_detections_one_batch(
                data.images(), [str(i) for i in range(7)], 0.005)
            return (detector.mesh, detector.pad_batches_to,
                    options.max_batch_size, records)
        finally:
            server.shutdown()

    m2, pad2, size2, rec2 = serve(2)
    out = capsys.readouterr().out
    assert m2 is not None and m2.devices.size == 2
    assert pad2 == size2 == 4
    assert 'Rounded serving batch size up to 4 for 2 devices' in out
    m1, pad1, size1, rec1 = serve(1)
    assert m1 is None and pad1 == size1 == 3
    assert rec2 == rec1


def test_exported_artifact_takes_no_mesh(model_path, tmp_path):
    from megadetector_tpu_torch.detection.export_detector import (
        ExportedDetector, export_detector)
    artifact = str(tmp_path / 'm.mdpkg')
    export_detector(model_path, artifact, platforms=['cpu'],
                    batch_sizes=[2], aspects=['1:1'],
                    detector_options={'force_cpu': 'true'})
    detector = ExportedDetector(artifact, device='cpu')
    assert detector.supports_mesh is False and detector.mesh is None
    with pytest.raises(ValueError, match='no mesh'):
        detector.mesh = _cpu_mesh(2)
    with pytest.raises(ValueError, match='mesh'):
        ExportedDetector(artifact, device='cpu',
                         detector_options={'mesh': _cpu_mesh(2)})
    assert detector.attach_auto_mesh(3) == 3 and detector.mesh is None


#%% The dry run


def test_dryrun_multichip_matches_the_jax_dry_run(capsys):
    """The port's dry run on a CPU mesh of 2 against the JAX package's
    (which forces its virtual CPU devices; tests/conftest.py already made 8):
    the same inference line, the same positives, the losses within the
    printed digits (rtol 1e-5 beside the 4-decimal rounding)."""

    import re
    import __graft_entry__
    from megadetector_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(2, devices=['cpu', 'cpu'])
    ours = capsys.readouterr().out.splitlines()
    __graft_entry__.dryrun_multichip(2)
    ref = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith('dryrun_multichip')]
    ours = [line for line in ours if line.startswith('dryrun_multichip')]
    assert len(ours) == len(ref) == 3
    assert ours[0] == ref[0] == ('dryrun_multichip inference OK: 2 devices, '
                                 'batch 4, boxes (4, 100, 4)')
    assert out['inference']['boxes'].shape == (4, 100, 4)

    def numbers(line):
        return [float(v) for v in re.findall(r'[-\d.]+(?=,|$)', line)]

    loss_ref, positives_ref = numbers(ref[1])
    assert float(out['detector']['n_positives']) == positives_ref == \
        numbers(ours[1])[1]
    for metrics, line in ((out['detector'], ref[1]),
                          (out['classifier'], ref[2])):
        loss = float(metrics['loss'])
        assert abs(loss - numbers(line)[0]) <= 5e-5 + 1e-5 * abs(loss)


def test_dryrun_mesh_defaults_to_the_cards(monkeypatch):
    from megadetector_tpu_torch.parallel import dryrun
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert [str(d) for d in dryrun.dryrun_mesh(2).devices.flat] == \
        ['cuda:0', 'cuda:0']
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert [str(d) for d in dryrun.dryrun_mesh(2).devices.flat] == \
        ['cuda:0', 'cuda:1']
    assert [str(d) for d in dryrun.dryrun_mesh(
        3, devices=['cpu'] * 4).devices.flat] == ['cpu'] * 3
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        dryrun.dryrun_mesh(2)
