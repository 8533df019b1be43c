"""
The port's small host tools against the JAX package's, on the same inputs,
values returned and bytes written: utils/string_utils, utils/process_utils,
path_utils.unzip_file and safe_create_link, detection/change_detection
(every method and threshold mode, the CSV, the previews, the CLI),
detection/run_inference_with_yolo_val (a stand-in val.py: the chunked and
resumable route, the symlink farm, the unique-ID strategies, the parsed
console statistics), integration/xmp_integration (sidecars, and
process_input_data with a recording stand-in pyexiv2 injected through
sys.modules, without one, with renames, threads and a stand-in GUI) and
visualization/visualize_video_output (videos and frame folders, decoded
with cv2). Mirrors tests/test_misc_tools.py's process_utils, change
detection and fake-val.py tests, tests/test_breadth_tools.py's video and
XMP tests and tests/test_ecosystem_tools.py's string_utils test.
"""

import csv
import json
import os
import subprocess
import sys
import tempfile
import types
import zipfile

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_cct_data import pair  # noqa: E402
from torch_format_data import read, run_main  # noqa: E402

cv2 = pytest.importorskip('cv2')

STR = pair('utils.string_utils')
PROC = pair('utils.process_utils')
PATH = pair('utils.path_utils')
CD = pair('detection.change_detection')
YV = pair('detection.run_inference_with_yolo_val')
XMP = pair('integration.xmp_integration')
VV = pair('visualization.visualize_video_output')


#%% string_utils, process_utils, path_utils helpers


@pytest.mark.parametrize('value', [
    '3.5', 2, 'abc', None, '7', '7.5', '-4', ' 12 ', '1e3', [1], 'nan',
    '0x10', 4.0])
def test_string_predicates_match(value):
    assert STR[1].is_float(value) == STR[0].is_float(value)
    assert STR[1].is_int(value) == STR[0].is_int(value)


@pytest.mark.parametrize('size', [
    '3 MB', '1.5GB', '200k', 42, 7.5, '10 bytes', '12', '2 TB', '1 pb',
    '3 zb', 'lots', '4 K'])
def test_human_readable_to_bytes_matches(size):
    out = []
    for module in STR:
        try:
            out.append(module.human_readable_to_bytes(size))
        except ValueError as e:
            out.append(('ValueError', str(e)))
    assert out[0] == out[1]


def test_remove_ansi_codes_matches():
    for s in ('\x1b[31mred\x1b[0m', 'plain', '\x1b[1;32;40mbold\x1b[K!'):
        assert STR[1].remove_ansi_codes(s) == STR[0].remove_ansi_codes(s)


@pytest.mark.parametrize('cmd', ['echo hello; echo there', 'exit 3',
                                 'echo out; echo err 1>&2; exit 2',
                                 'printf "a\\nb"'])
def test_execute_and_print_matches(cmd, capsys):
    out = []
    for module in PROC:
        result = module.execute_and_print(cmd, print_output=True)
        out.append((result, capsys.readouterr().out))
        with pytest.raises(Exception) if result['status'] else \
                _nothing():
            module.execute_and_print(cmd, print_output=False,
                                     catch_exceptions=False)
        try:
            lines = list(module.execute(cmd))
        except subprocess.CalledProcessError as e:
            lines = ('raised', e.returncode)
        out.append(lines)
    assert out[:2] == out[2:]


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


def test_execute_passes_env_and_get_process_list():
    env = dict(os.environ, MD_PROBE='probe-value')
    for module in PROC:
        assert list(module.execute('echo $MD_PROBE', env=env)) == \
            ['probe-value\n']
        processes = module.get_process_list()
        assert (os.getpid(), open('/proc/self/comm').read().strip()) in \
            processes or any(pid == os.getpid() for pid, _ in processes)


def test_unzip_file_and_safe_create_link_match(tmp_path):
    archive = str(tmp_path / 'a.zip')
    with zipfile.ZipFile(archive, 'w') as z:
        z.writestr('x/y.txt', 'hello')
        z.writestr('z.bin', bytes(range(50)))
    out = []
    for side, module in enumerate(PATH):
        dest = str(tmp_path / 'out{}'.format(side))
        assert module.unzip_file(archive, dest) == dest
        target = str(tmp_path / 'target{}'.format(side))
        open(target, 'w').write('t')
        link = str(tmp_path / 'link{}'.format(side))
        module.safe_create_link(target, link)
        module.safe_create_link(target, link)  # already right: kept
        other = target + '.other'
        open(other, 'w').write('o')
        module.safe_create_link(other, link)  # stale: replaced
        out.append((sorted(os.listdir(dest)), read(os.path.join(
            dest, 'x', 'y.txt')), os.readlink(link) == other))
    assert out[0] == out[1] == ([('x'), 'z.bin'], b'hello', True)
    default = [module.unzip_file(archive) for module in PATH]
    assert default[0] == default[1] == str(tmp_path / 'a')


#%% change_detection


def _camera_folders(root, seed=0):
    """Two camera folders of gray JPEGs: a static scene, then objects
    that appear and move; one unreadable file."""

    rng = np.random.RandomState(seed)
    for cam in range(2):
        folder = os.path.join(root, 'cam{}'.format(cam))
        os.makedirs(folder)
        base = rng.randint(80, 130, (90, 160, 3)).astype(np.uint8)
        for i in range(7):
            img = base.copy()
            if i >= 3:
                x = 20 + 12 * i + 5 * cam
                img[20:60, x:x + 40] = 240 - 30 * cam
            img = np.clip(img.astype(np.int16) +
                          rng.randint(-3, 4, img.shape), 0, 255)
            cv2.imwrite(os.path.join(folder, 'img_{:02d}.jpg'.format(i)),
                        img.astype(np.uint8))
    with open(os.path.join(root, 'cam1', 'img_99.jpg'), 'wb') as f:
        f.write(b'not a jpeg')


@pytest.fixture(scope='module')
def cameras(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('cameras'))
    _camera_folders(root)
    return root


def _rel(results, root):
    return [dict(r, file=os.path.relpath(r['file'], root)) for r in results]


@pytest.mark.parametrize('method', ['frame_diff', 'mog2', 'knn',
                                    'motion_history'])
@pytest.mark.parametrize('threshold', ['global', 'otsu', 'adaptive'])
def test_change_detection_matches(cameras, tmp_path, method, threshold,
                                  capsys):
    out = []
    for side, module in enumerate(CD):
        options = module.ChangeDetectionOptions()
        options.method = method
        options.threshold_method = threshold
        options.motion_fraction_threshold = 0.01
        options.comparison_width = 120
        root = str(tmp_path / str(side))
        csv_path = os.path.join(root, 'motion.csv')
        os.makedirs(root)
        results = module.process_folders(cameras, csv_path, options)
        previews = module.create_change_previews(
            results, os.path.join(root, 'prev'), num_samples=3,
            random_seed=1, comparison_width=120)
        out.append((_rel(results, cameras), read(csv_path),
                    [(os.path.basename(p), read(p)) for p in previews],
                    capsys.readouterr().out.replace(root, '')))
    assert out[0] == out[1]
    assert any(r.get('failure') for r in out[1][0])
    if method == 'frame_diff' and threshold == 'global':
        flagged = [r['file'] for r in out[1][0] if r['motion']]
        assert 'cam0/img_03.jpg' in flagged and 'cam0/img_01.jpg' not in \
            flagged
        assert out[1][2]


def test_detect_motion_and_subtractor_helpers_match(cameras):
    paths = sorted(os.path.join(cameras, 'cam0', f)
                   for f in os.listdir(os.path.join(cameras, 'cam0')))
    for method in ('mog2', 'knn', 'frame_diff'):
        subs = []
        for module in CD:
            options = module.ChangeDetectionOptions()
            options.method = method
            subs.append(type(module.create_background_subtractor(options)))
        assert subs[0] == subs[1]
    assert CD[1].DetectionMethod.KNN == CD[0].DetectionMethod.KNN == 'knn'
    assert CD[1].ThresholdType.OTSU == CD[0].ThresholdType.OTSU
    a = CD[1].detect_motion(paths)
    assert a == CD[0].detect_motion(paths)
    assert CD[1].process_camera_folder('cam0', paths[::-1]) == a
    state = [m.MotionHistoryState(buffer_size=3) for m in CD]
    options = CD[0].ChangeDetectionOptions()
    frames = [cv2.imread(p, cv2.IMREAD_GRAYSCALE) for p in paths]
    for frame in frames + [frames[0][:40]]:
        outs = [s.update(frame, options) for s in state]
        assert np.array_equal(outs[0], outs[1])


@pytest.mark.parametrize('extra', [[], ['--method', 'knn',
                                        '--preview_folder', 'PREV',
                                        '--num_previews', '2',
                                        '--threshold_method', 'otsu']])
def test_change_detection_cli_matches(cameras, tmp_path, monkeypatch,
                                      capsys, extra):
    out = []
    for side, module in enumerate(CD):
        prev = str(tmp_path / 'prev{}'.format(side))
        csv_path = str(tmp_path / 'cli{}.csv'.format(side))
        argv = ['cd', cameras, csv_path] + [prev if a == 'PREV' else a
                                            for a in extra]
        run_main(module, argv, monkeypatch)
        files = sorted(os.listdir(prev)) if os.path.isdir(prev) else []
        out.append((read(csv_path), files, [read(os.path.join(prev, f))
                                            for f in files]))
    assert out[0] == out[1]
    capsys.readouterr()


#%% run_inference_with_yolo_val with a stand-in val.py


FAKE_VAL = '''
import argparse, json, os, sys
p = argparse.ArgumentParser()
for a in ('--task','--data','--weights','--device','--name'):
    p.add_argument(a)
for a in ('--batch-size','--imgsz'):
    p.add_argument(a, type=int)
p.add_argument('--conf-thres', type=float)
p.add_argument('--save-json', action='store_true')
p.add_argument('--project')
p.add_argument('--exist-ok', action='store_true')
p.add_argument('--augment', action='store_true')
args = p.parse_args()
folder = None
for line in open(args.data):
    if line.startswith('path:'):
        folder = line.split(':', 1)[1].strip()
preds = []
for i, fn in enumerate(sorted(os.listdir(folder))):
    base, ext = os.path.splitext(fn)
    if ext.lower() not in ('.jpg', '.jpeg', '.png'):
        continue
    preds.append({'image_id': base, 'category_id': i % 3,
                  'bbox': [15.0 + i, 10.0, 30.0, 20.0 + i],
                  'score': 0.9 - 0.01 * i})
    if args.augment:
        preds.append({'image_id': base, 'category_id': 0,
                      'bbox': [1.0, 2.0, 3.0, 4.0], 'score': 0.3})
out_dir = os.path.join(args.project, 'results')
os.makedirs(out_dir, exist_ok=True)
with open(os.path.join(out_dir, 'best_predictions.json'), 'w') as f:
    json.dump(preds, f)
print('weights', args.weights, 'device', args.device, 'imgsz', args.imgsz)
'''


@pytest.fixture(scope='module')
def yolo_world(tmp_path_factory):
    root = tmp_path_factory.mktemp('yolo_world')
    dup = root / 'dup'
    unique = root / 'unique'
    rng = np.random.RandomState(5)
    for cam in ('camA', 'camB'):
        for folder in (dup, unique):
            (folder / cam).mkdir(parents=True)
        for i in range(3):
            img = rng.randint(0, 255, (40 + 8 * i, 60, 3)).astype(np.uint8)
            cv2.imwrite(str(dup / cam / 'pic{}.jpg'.format(i)), img)
            cv2.imwrite(str(unique / cam / '{}_pic{}.jpg'.format(cam, i)),
                        img)
    repo = root / 'yolo_repo'
    repo.mkdir()
    (repo / 'val.py').write_text(FAKE_VAL)
    return dict(dup=str(dup), unique=str(unique), repo=str(repo))


def _yolo_options(module, world, folder, out, **kwargs):
    options = module.YoloInferenceOptions()
    options.input_folder = world[folder]
    options.model_filename = 'fake.pt'
    options.output_file = out
    options.yolo_working_folder = world['repo']
    for k, v in kwargs.items():
        setattr(options, k, v)
    return options


@pytest.mark.parametrize('route', [
    dict(folder='dup', checkpoint_frequency=4),
    dict(folder='dup'),
    dict(folder='dup', unique_id_strategy='auto', augment=True),
    dict(folder='unique', unique_id_strategy='auto', checkpoint_frequency=5),
    dict(folder='unique', unique_id_strategy='verify'),
], ids=['chunked', 'links', 'auto-links', 'auto-chunked', 'verify'])
def test_yolo_val_runner_matches(yolo_world, tmp_path, monkeypatch, route,
                                 capsys):
    # The JAX module writes its dataset YAML to one fixed path in the
    # temporary folder: a folder of this test's own keeps other processes'
    # runs (the JAX package's tests) out of it
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    route = dict(route)
    folder = route.pop('folder')
    out = []
    for side, module in enumerate(YV):
        md_file = str(tmp_path / 'md{}.json'.format(side))
        extra = dict(route)
        if 'checkpoint_frequency' in extra:
            extra['checkpoint_folder'] = str(tmp_path / 'ck{}'.format(side))
        extra['symlink_folder'] = str(tmp_path / 'links{}'.format(side))
        options = _yolo_options(module, yolo_world, folder, md_file, **extra)
        md = module.run_inference_with_yolo_val(options)
        first = read(md_file)
        if 'checkpoint_frequency' in extra:
            os.remove(md_file)
            shards = sorted(os.listdir(extra['checkpoint_folder']))
            md = module.run_inference_with_yolo_val(options)
            printed = capsys.readouterr().out
            assert printed.count('Skipping completed chunk') == 2
        else:
            shards = None
        out.append((md, first, read(md_file), shards,
                    os.path.exists(extra['symlink_folder'])))
    assert out[0] == out[1]
    md = out[1][0]
    assert len(md['images']) == 6
    assert all(len(im['detections']) == (2 if route.get('augment') else 1)
               for im in md['images'])


def test_yolo_val_runner_refusals_match(yolo_world, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    for module in YV:
        for kwargs in (dict(unique_id_strategy='verify'),
                       dict(unique_id_strategy='other'),
                       dict(yolo_working_folder=str(tmp_path))):
            options = _yolo_options(module, yolo_world, 'dup',
                                    str(tmp_path / 'x.json'), **kwargs)
            with pytest.raises(AssertionError):
                module.run_inference_with_yolo_val(options)
        options = _yolo_options(module, yolo_world, 'unique',
                                str(tmp_path / 'x.json'),
                                unique_id_strategy='verify',
                                model_filename='"; exit 4; echo "')
        with pytest.raises(RuntimeError):
            module.run_inference_with_yolo_val(options)


def test_dataset_yaml_is_private_to_each_run_where_jax_shares_one(
        tmp_path, monkeypatch):
    """A known fault of the JAX module: _write_dataset_yaml writes one
    fixed path in the temporary folder, so two runs at once (two jobs,
    two test workers) read each other's image folder. The port writes a
    file of its own per run, with the same text."""

    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    paths = {}
    for side, module in enumerate(YV):
        a = module._write_dataset_yaml('/data/a')
        text_a = read(a)
        b = module._write_dataset_yaml('/data/b')
        paths[side] = (a, b, text_a, read(a), read(b))
    jax_a, jax_b, jax_text_a, jax_a_after, jax_text_b = paths[0]
    a, b, text_a, a_after, text_b = paths[1]
    assert jax_a == jax_b and jax_a_after == jax_text_b
    assert a != b and a_after == text_a == jax_text_a
    assert text_b == jax_text_b


def test_yolo_val_asks_for_the_card_where_jax_asks_for_the_cpu(
        yolo_world, tmp_path, monkeypatch):
    """A difference on purpose: the port's val.py command names the first
    CUDA device ('0', YOLOv5's name for it) unless told otherwise, where
    the JAX module's default is 'cpu'; the port's CLI sets it with
    --device_string. The results are the same, and the port removes each
    run's dataset YAML when the run ends."""

    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    commands = []
    for module in YV:
        run = module.execute_and_print

        def recording(cmd, run=run, **kwargs):
            commands.append(cmd)
            return run(cmd, **kwargs)

        monkeypatch.setattr(module, 'execute_and_print', recording)
    out = []
    for side, module in enumerate(YV):
        md_file = str(tmp_path / 'device{}.json'.format(side))
        module.run_inference_with_yolo_val(_yolo_options(
            module, yolo_world, 'unique', md_file,
            unique_id_strategy='verify'))
        out.append(read(md_file))
    assert out[0] == out[1]
    assert ' --device cpu ' in commands[0]
    assert ' --device 0 ' in commands[1]
    for argv, device in (([], '0'), (['--device_string', 'cpu'], 'cpu'),
                         (['--device_string', '1'], '1')):
        run_main(YV[1], ['yv', 'fake.pt', yolo_world['unique'],
                         str(tmp_path / 'cli.json'), '--yolo_working_folder',
                         yolo_world['repo']] + argv, monkeypatch)
        assert ' --device {} '.format(device) in commands[-1]
    # The JAX module's one fixed YAML stays; none of the port's four do
    yamls = [f for f in os.listdir(str(tmp_path))
             if f.startswith('yolo_val_dataset')]
    assert yamls == ['yolo_val_dataset.yaml']


def test_get_stats_for_category_matches(tmp_path):
    console = str(tmp_path / 'val.txt')
    with open(console, 'w') as f:
        f.write('   Class  Images  Labels   P   R  mAP50  mAP50-95\n')
        f.write('     all     100     250  0.9 0.8  0.85  0.6\n')
        f.write('alligator 5 7 0.5 0.4 0.3 0.2\n')
        f.write('  animal      90     200  0.92 0.81  0.86  0.61\n')
    for category in ('all', 'animal', 'vehicle', 'alligator'):
        assert YV[1].get_stats_for_category(console, category) == \
            YV[0].get_stats_for_category(console, category)
    bad = str(tmp_path / 'bad.txt')
    with open(bad, 'w') as f:
        f.write('all 1 2 0.1 0.2 0.3 0.4\n')
    for module in YV:
        with pytest.raises(AssertionError):
            module.get_stats_for_category(bad, 'all')


def test_yolo_val_cli_matches(yolo_world, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    out = []
    for side, module in enumerate(YV):
        md_file = str(tmp_path / 'cli{}.json'.format(side))
        run_main(module, ['yv', 'fake.pt', yolo_world['unique'], md_file,
                          '--yolo_working_folder', yolo_world['repo'],
                          '--image_size', '640', '--augment'], monkeypatch)
        out.append(read(md_file))
    assert out[0] == out[1]
    capsys.readouterr()


#%% xmp_integration


def _xmp_world(root, seed=0):
    rng = np.random.RandomState(seed)
    folder = os.path.join(root, 'images')
    os.makedirs(os.path.join(folder, 'sub'))
    images = []
    for i in range(8):
        fn = ('sub/' if i % 3 == 0 else '') + 'im{}.jpg'.format(i)
        cv2.imwrite(os.path.join(folder, fn),
                    rng.randint(0, 255, (20, 30, 3)).astype(np.uint8))
        dets = []
        for _ in range(int(rng.randint(0, 4))):
            det = {'category': str(1 + rng.randint(0, 3)),
                   'conf': float(np.round(rng.rand(), 3)),
                   'bbox': [0.1, 0.1, 0.2, 0.2]}
            if rng.rand() < 0.5:
                det['classifications'] = [['0', float(np.round(rng.rand(),
                                                               3))],
                                          ['1', 0.6]]
            dets.append(det)
        images.append({'file': 'PREFIX/' + fn if i == 5 else fn,
                       'detections': dets})
    images.append({'file': 'missing.jpg', 'detections': []})
    images.append({'file': 'im1.jpg', 'detections': None,
                   'failure': 'x'})
    results = {'images': images,
               'detection_categories': {'1': 'animal', '2': 'person',
                                        '3': 'vehicle'},
               'classification_categories': {'0': 'deer', '1': 'fox'},
               'info': {}}
    path = os.path.join(root, 'results.json')
    with open(path, 'w') as f:
        json.dump(results, f)
    return folder, path


def _folder_bytes(folder):
    out = {}
    for dirpath, _, files in os.walk(folder):
        for fn in files:
            p = os.path.join(dirpath, fn)
            out[os.path.relpath(p, folder)] = read(p)
    return out


@pytest.mark.parametrize('threshold', [0.0, 0.2, 0.7])
def test_write_results_to_xmp_matches(tmp_path, threshold, capsys):
    out = []
    for side, module in enumerate(XMP):
        root = str(tmp_path / str(side))
        folder, results = _xmp_world(root)
        written = module.write_results_to_xmp(
            results, folder, confidence_threshold=threshold,
            classification_threshold=0.5, tag_prefix='MD')
        out.append(([os.path.relpath(p, folder) for p in written],
                    _folder_bytes(folder)))
    assert out[0] == out[1]
    assert any('MD|empty' in v.decode() for k, v in out[1][1].items()
               if k.endswith('.xmp'))
    capsys.readouterr()


class _RecordingExiv2:
    """A stand-in pyexiv2 module recording each modify_xmp call."""

    def __init__(self, root):
        self.calls = []
        self.root = root
        recorder = self

        class Image:
            def __init__(self, path):
                self.path = path

            def modify_xmp(self, tags):
                recorder.calls.append(
                    (os.path.relpath(self.path, recorder.root), tags))

        self.module = types.ModuleType('pyexiv2')
        self.module.Image = Image


@pytest.mark.parametrize('setting', [
    dict(min_threshold='0.3'),
    dict(min_threshold='', rename_conf='0.5', rename_cats='all',
         remove_path='PREFIX/'),
    dict(min_threshold=None, rename_conf='0.8', rename_cats='animal,person',
         num_threads=3),
    dict(min_threshold='0.1', rename_cats='vehicle', num_threads=''),
], ids=['threshold', 'rename-all', 'rename-threads', 'cats-only'])
@pytest.mark.parametrize('exiv2', [True, False], ids=['pyexiv2', 'sidecars'])
def test_process_input_data_matches(tmp_path, monkeypatch, capsys, setting,
                                    exiv2):
    out = []
    for side, module in enumerate(XMP):
        root = str(tmp_path / str(side))
        folder, results = _xmp_world(root)
        recorder = _RecordingExiv2(folder)
        monkeypatch.setitem(sys.modules, 'pyexiv2',
                            recorder.module if exiv2 else None)
        options = module.xmp_integration_options()
        options.image_folder = folder
        options.input_file = results
        for k, v in setting.items():
            setattr(options, k, v)
        module.process_input_data(options)
        printed = capsys.readouterr().out.replace(root, '<root>')
        out.append((sorted(recorder.calls), _folder_bytes(folder),
                    sorted(printed.splitlines())))
    assert out[0] == out[1]
    if exiv2:
        assert out[1][0] and not any(k.endswith('.xmp') for k in out[1][1])
    else:
        assert any(k.endswith('.xmp') for k in out[1][1])


def test_xmp_gui_hooks_match(tmp_path, monkeypatch, capsys):
    """update_xmp_metadata and write_status with a stand-in GUI (its
    progress goes through root.after) and a stand-in tkinter module; no
    window is built."""

    tk = types.ModuleType('tkinter')
    tk.END = 'end'
    monkeypatch.setitem(sys.modules, 'tkinter', tk)
    monkeypatch.setitem(sys.modules, 'pyexiv2', None)

    class Text:
        def __init__(self):
            self.log = []

        def configure(self, **kwargs):
            self.log.append(('configure', kwargs))

        def insert(self, where, s):
            self.log.append(('insert', where, s))

        def get(self):
            return self.value

    out = []
    for side, module in enumerate(XMP):
        root = str(tmp_path / str(side))
        folder, results = _xmp_world(root)
        gui = module.xmp_gui()
        gui.root = types.SimpleNamespace(
            after=lambda delay, fn: fn())
        gui.progress_bar = {}
        gui.textarea_status = Text()
        for attr, value in (('textarea_remove_path', 'PREFIX/'),
                            ('textarea_rename_conf', '0.4'),
                            ('textarea_rename_cats', 'all'),
                            ('textarea_num_threads', '1'),
                            ('textarea_min_threshold', '0.2')):
            text = Text()
            text.value = value
            setattr(gui, attr, text)
        options = module.xmp_integration_options()
        options.image_folder = folder
        options.input_file = results
        options.xmp_gui = gui
        module.process_input_data(options)
        status = [e[2].replace(root, '<root>') for e in
                  gui.textarea_status.log if e[0] == 'insert']
        out.append((gui.progress_bar, sorted(status),
                    _folder_bytes(folder)))
        assert isinstance(module.start_input_processing, types.FunctionType)
    assert out[0] == out[1]
    # 8 of the 10 records name an image on disk
    assert out[1][0] == {'value': 80}
    capsys.readouterr()


@pytest.mark.parametrize('argv', [
    ['--confidence_threshold', '0.4'],
    ['--embedded', '--rename_conf', '0.5', '--rename_cats', 'all'],
], ids=['sidecars', 'embedded'])
def test_xmp_cli_matches(tmp_path, monkeypatch, capsys, argv):
    monkeypatch.setitem(sys.modules, 'pyexiv2', None)
    out = []
    for side, module in enumerate(XMP):
        root = str(tmp_path / str(side))
        folder, results = _xmp_world(root)
        run_main(module, ['xmp', results, folder] + argv, monkeypatch)
        out.append(_folder_bytes(folder))
    assert out[0] == out[1]
    capsys.readouterr()


#%% visualize_video_output


@pytest.fixture(scope='module')
def videos(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('videos'))
    folder = os.path.join(root, 'videos')
    rng = np.random.RandomState(0)
    images = []
    for i, (name, n_frames) in enumerate((('a/v0.mp4', 8), ('v1.mp4', 6),
                                          ('b/c/v2.mp4', 7), ('v3.mp4', 5))):
        path = os.path.join(folder, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'),
                                 5.0 + i, (64, 48))
        for _ in range(n_frames):
            writer.write(rng.randint(0, 255, (48, 64, 3), dtype=np.uint8))
        writer.release()
        dets = []
        for frame in sorted(rng.choice(n_frames, 3, replace=False)):
            dets.append({'category': str(1 + rng.randint(0, 3)),
                         'conf': float(np.round(0.1 + 0.9 * rng.rand(), 3)),
                         'bbox': [0.1, 0.1, 0.3, 0.4],
                         'frame_number': int(frame)})
            if rng.rand() < 0.5:
                dets[-1]['classifications'] = [['0', 0.8]]
        images.append({'file': name, 'frame_rate': 5.0 + i,
                       'detections': dets})
    images.append({'file': 'missing.mp4', 'detections': []})
    images.append({'file': 'failed.mp4', 'detections': None,
                   'failure': 'x'})
    results = {'images': images,
               'detection_categories': {'1': 'animal', '2': 'person',
                                        '3': 'vehicle'},
               'classification_categories': {'0': 'deer'}, 'info': {}}
    path = os.path.join(root, 'videos.json')
    with open(path, 'w') as f:
        json.dump(results, f)
    return dict(folder=folder, results=path)


def _decoded(path):
    frames = []
    cap = cv2.VideoCapture(path)
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames) if frames else None


@pytest.mark.parametrize('setting', [
    dict(),
    dict(render_frames_only=True, confidence_threshold=0.3),
    dict(sample=2, random_seed=3, trim_to_detections=True, rendering_fs=4),
    dict(sample=2, flatten_output=False, render_frames_only=True),
], ids=['videos', 'frames', 'sampled-trimmed', 'unflattened-frames'])
def test_visualize_video_output_matches(videos, tmp_path, setting, capsys):
    out = []
    for side, module in enumerate(VV):
        options = module.VideoVisualizationOptions()
        for k, v in setting.items():
            setattr(options, k, v)
        dest = str(tmp_path / str(side))
        outputs = module.visualize_video_output(
            videos['results'], videos['folder'], dest, options=options)
        decoded = []
        for p in outputs:
            if p.endswith('.mp4'):
                decoded.append(_decoded(p))
            else:
                decoded.append(cv2.imread(p))
        out.append(([os.path.relpath(p, dest) for p in outputs], decoded))
    assert out[0][0] == out[1][0] and out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert a is not None and np.array_equal(a, b)
    if not setting.get('render_frames_only'):
        n_frames = [len(d) for d in out[1][1]]
        if setting.get('trim_to_detections'):
            assert all(n <= 8 for n in n_frames)
        else:
            assert n_frames == [8, 6, 7, 5]
    capsys.readouterr()


def test_visualize_video_output_overrides_and_cli(videos, tmp_path,
                                                   monkeypatch, capsys):
    out = []
    for side, module in enumerate(VV):
        dest = str(tmp_path / 'kw{}'.format(side))
        outputs = module.visualize_video_output(
            videos['results'], videos['folder'], dest,
            confidence_threshold=0.5, fourcc='mp4v',
            render_frames_only=True, sample=3)
        cli = str(tmp_path / 'cli{}'.format(side))
        run_main(module, ['vv', videos['results'], videos['folder'], cli,
                          '--frames_only', '--confidence_threshold', '0.25',
                          '--sample', '2', '--rendering_fs', '3'],
                 monkeypatch)
        out.append(([os.path.relpath(p, dest) for p in outputs],
                    [cv2.imread(p) for p in outputs],
                    sorted(os.path.relpath(os.path.join(d, f), cli)
                           for d, _, fs in os.walk(cli) for f in fs)))
    assert out[0][0] == out[1][0] and out[0][2] == out[1][2]
    for a, b in zip(out[0][1], out[1][1]):
        assert np.array_equal(a, b)
    capsys.readouterr()
