"""
The port's copies of three host modules, held to the JAX package's on the
CPU: they write the same bytes.

- postprocessing/evaluate_detections: mAP@0.5 and the COCO ladder, with
  a confidence floor, from files and from dicts, and the CLI's output
  file;
- utils/extract_frames_from_video (on the port's detection/video_utils):
  one video sampled every 4th frame, a folder at every frame, a width
  cap, the frames an MD results file references, and the CLI;
- utils/url_utils, offline only: downloads from a file:// URL and from
  the module's own SingletonHTTPServer serving a temporary folder on a
  local port (relative filenames, parallel downloads, sizes, status
  codes, a missing file), and the progress callback.
"""

import json
import os
import sys

import numpy as np
import pytest

from megadetector_tpu.postprocessing import \
    evaluate_detections as jax_evaluate
from megadetector_tpu.utils import url_utils as jax_url_utils
from megadetector_tpu_torch.postprocessing import evaluate_detections
from megadetector_tpu_torch.utils import url_utils


def _tree(root):
    out = {}
    for folder, _, files in os.walk(root):
        for name in files:
            path = os.path.join(folder, name)
            with open(path, 'rb') as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


#%% evaluate_detections


def _md_and_gt(seed=0, n_images=12):
    rng = np.random.RandomState(seed)
    images, gt_images, annotations = [], [], []
    for i in range(n_images):
        name = 'im{:02d}.jpg'.format(i)
        w, h = int(rng.randint(200, 400)), int(rng.randint(150, 300))
        gt_images.append({'id': i, 'file_name': name, 'width': w,
                          'height': h})
        dets = []
        for _ in range(rng.randint(0, 5)):
            x, y = rng.uniform(0, 0.7, 2)
            bw, bh = rng.uniform(0.05, 0.3, 2)
            cat = int(rng.randint(1, 4))
            annotations.append({'id': len(annotations), 'image_id': i,
                                'category_id': cat,
                                'bbox': [x * w, y * h, bw * w, bh * h]})
            jitter = rng.uniform(-0.02, 0.02, 4)
            dets.append({'category': str(cat if rng.rand() > 0.2 else
                                         rng.randint(1, 4)),
                         'conf': float(np.round(rng.uniform(0.05, 1), 3)),
                         'bbox': [float(v) for v in np.clip(
                             np.array([x, y, bw, bh]) + jitter, 0, 1)]})
        for _ in range(rng.randint(0, 3)):
            dets.append({'category': str(rng.randint(1, 4)),
                         'conf': float(np.round(rng.uniform(0, 0.6), 3)),
                         'bbox': [float(v) for v in rng.uniform(0, 0.5, 4)]})
        images.append({'file': name, 'detections': dets})
    images.append({'file': 'broken.jpg', 'detections': None,
                   'failure': 'image access failure'})
    md = {'images': images, 'detection_categories': {
        '1': 'animal', '2': 'person', '3': 'vehicle'}, 'info': {}}
    gt = {'images': gt_images, 'annotations': annotations,
          'categories': [{'id': 1, 'name': 'animal'},
                         {'id': 2, 'name': 'person'},
                         {'id': 3, 'name': 'vehicle'}]}
    return md, gt


@pytest.mark.parametrize('ladder', [False, True])
@pytest.mark.parametrize('min_confidence', [0.0, 0.3])
def test_evaluate_detections_matches_jax(tmp_path, ladder, min_confidence):
    md, gt = _md_and_gt()
    md_file, gt_file = str(tmp_path / 'md.json'), str(tmp_path / 'gt.json')
    with open(md_file, 'w') as f:
        json.dump(md, f)
    with open(gt_file, 'w') as f:
        json.dump(gt, f)
    thresholds = evaluate_detections.COCO_IOU_THRESHOLDS if ladder \
        else (0.5,)
    assert evaluate_detections.COCO_IOU_THRESHOLDS == \
        jax_evaluate.COCO_IOU_THRESHOLDS
    for args in ((md_file, gt_file), (md, gt)):
        ours = evaluate_detections.evaluate_detections(
            *args, iou_thresholds=thresholds,
            min_confidence=min_confidence)
        ref = jax_evaluate.evaluate_detections(
            *args, iou_thresholds=thresholds, min_confidence=min_confidence)
        assert json.dumps(ours) == json.dumps(ref)
    assert ours['mAP'] is not None


def test_evaluate_detections_cli_matches_jax(tmp_path, monkeypatch,
                                             capsys):
    md, gt = _md_and_gt(seed=1)
    md_file, gt_file = str(tmp_path / 'md.json'), str(tmp_path / 'gt.json')
    with open(md_file, 'w') as f:
        json.dump(md, f)
    with open(gt_file, 'w') as f:
        json.dump(gt, f)
    outputs = []
    for name, module in (('ours', evaluate_detections),
                         ('ref', jax_evaluate)):
        out = str(tmp_path / '{}.json'.format(name))
        monkeypatch.setattr(sys, 'argv', [
            'evaluate_detections', md_file, gt_file, '--coco_ladder',
            '--min_confidence', '0.1', '--output_file', out])
        module.main()
        with open(out, 'rb') as f:
            outputs.append(f.read())
    assert outputs[0] == outputs[1]
    printed = capsys.readouterr().out
    assert printed == 2 * (outputs[0].decode() + '\n')


#%% extract_frames_from_video


@pytest.fixture(scope='module')
def videos(tmp_path_factory):
    cv2 = pytest.importorskip('cv2')
    folder = tmp_path_factory.mktemp('torch_frames')
    rng = np.random.RandomState(0)
    for name, n_frames in (('a.mp4', 12), ('sub/b.mp4', 8)):
        path = str(folder / name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'), 4.0,
                              (64, 48))
        for _ in range(n_frames):
            out.write(rng.randint(0, 255, (48, 64, 3), dtype=np.uint8))
        out.release()
    results = str(folder / 'results.json')
    with open(results, 'w') as f:
        json.dump({'images': [
            {'file': 'a.mp4', 'frames_processed': [0, 3, 6, 9],
             'detections': [
                 {'category': '1', 'conf': 0.9, 'frame_number': 3,
                  'bbox': [0.1, 0.1, 0.2, 0.2]},
                 {'category': '1', 'conf': 0.8, 'frame_number': 9,
                  'bbox': [0.1, 0.1, 0.2, 0.2]}]},
            {'file': 'sub/b.mp4', 'frames_processed': [0, 4],
             'detections': []},
            {'file': 'gone.mp4', 'detections': [
                {'category': '1', 'conf': 0.9, 'frame_number': 0,
                 'bbox': [0.1, 0.1, 0.2, 0.2]}]}]}, f)
    return str(folder), results


# (source relative to the video folder, options)
FRAME_CASES = {
    'single_every_4th': ('a.mp4', {'frame_sample': 4}),
    'folder_every_frame': ('', {}),
    'folder_max_width': ('', {'max_width': 32, 'quality': 60}),
    'detector_output': ('', {'detector_output_file': True}),
}


@pytest.mark.parametrize('case', sorted(FRAME_CASES))
def test_extract_frames_matches_jax(videos, tmp_path, case):
    from megadetector_tpu.utils import extract_frames_from_video as jax_ef
    from megadetector_tpu_torch.utils import extract_frames_from_video as ef

    folder, results = videos
    source, settings = FRAME_CASES[case]
    summaries, trees = [], []
    for name, module in (('ours', ef), ('ref', jax_ef)):
        options = module.FrameExtractionOptions()
        for k, v in settings.items():
            setattr(options, k, results if v is True else v)
        out = str(tmp_path / name)
        summaries.append(module.extract_frames(
            os.path.join(folder, source), out, options))
        trees.append(_tree(out))
        for k in summaries[-1]:
            if isinstance(summaries[-1][k], str):
                summaries[-1][k] = summaries[-1][k].replace(out, '<out>')
    assert trees[0] == trees[1] and len(trees[0]) > 0
    assert json.dumps(summaries[0], sort_keys=True, default=str) == \
        json.dumps(summaries[1], sort_keys=True, default=str)


def test_extract_frames_cli_matches_jax(videos, tmp_path, monkeypatch,
                                        capsys):
    from megadetector_tpu.utils import extract_frames_from_video as jax_ef
    from megadetector_tpu_torch.utils import extract_frames_from_video as ef

    folder, _ = videos
    trees = []
    for name, module in (('ours', ef), ('ref', jax_ef)):
        out = str(tmp_path / name)
        monkeypatch.setattr(sys, 'argv', ['extract_frames_from_video',
                                          folder, out, '--frame_sample',
                                          '3'])
        module.main()
        trees.append(_tree(out))
    assert trees[0] == trees[1] and len(trees[0]) == 7
    assert capsys.readouterr().out.count('Extracted 7 frames') == 2


#%% url_utils (offline)


def _served_folder(tmp_path):
    root = tmp_path / 'served'
    (root / 'sub dir').mkdir(parents=True)
    files = {'a.bin': b'a' * 1234, 'sub dir/b.txt': b'hello\n' * 50}
    for name, blob in files.items():
        with open(str(root / name), 'wb') as f:
            f.write(blob)
    return str(root), files


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_download_from_a_file_url(tmp_path):
    root, files = _served_folder(tmp_path)
    url = 'file://' + os.path.join(root, 'a.bin')
    for module in (url_utils, jax_url_utils):
        dst = str(tmp_path / '{}.bin'.format(module.__name__))
        assert module.download_url(url, dst) == dst
        with open(dst, 'rb') as f:
            assert f.read() == files['a.bin']
        # An existing destination is kept unless forced
        with open(dst, 'wb') as f:
            f.write(b'kept')
        module.download_url(url, dst)
        with open(dst, 'rb') as f:
            assert f.read() == b'kept'
        module.download_url(url, dst, force_download=True)
        with open(dst, 'rb') as f:
            assert f.read() == files['a.bin']
    assert url_utils.get_temp_folder('md_port_test').endswith(
        'md_port_test')


def test_downloads_from_the_local_server(tmp_path):
    root, files = _served_folder(tmp_path)
    base = url_utils.SingletonHTTPServer.start_server(
        root, port=_free_port(), host='127.0.0.1')
    try:
        urls = {name: '{}/{}'.format(base, name.replace(' ', '%20'))
                for name in files}
        missing = base + '/missing.bin'
        outs = []
        for module in (url_utils, jax_url_utils):
            out = str(tmp_path / module.__name__.split('.')[0])
            got = module.download_relative_filename(urls['sub dir/b.txt'],
                                                    out)
            targets = {u: os.path.join(out, 'p', os.path.basename(n))
                       for n, u in urls.items()}
            targets[missing] = os.path.join(out, 'p', 'missing.bin')
            status = module.parallel_download_urls(targets, n_workers=2)
            outs.append((os.path.relpath(got, out),
                         {u: (s['status'], os.path.relpath(
                             s['target_file'], out))
                          for u, s in status.items()},
                         module.get_url_size(urls['a.bin']),
                         module.get_url_sizes([urls['a.bin'], missing]),
                         module.test_urls([urls['a.bin'], missing],
                                          error_on_failure=False),
                         _tree(out)))
        assert outs[0] == outs[1]
        assert outs[0][2] == 1234 and outs[0][3][missing] is None
        assert outs[0][4] == [200, -1]
        assert outs[0][1][missing][0] == 'error'
        with pytest.raises(ValueError, match='Error accessing'):
            url_utils.test_urls([missing])
    finally:
        url_utils.SingletonHTTPServer.stop_server()


def test_progress_callback(capsys):
    bar = url_utils.DownloadProgressBar()
    for block in range(12):
        bar(block, 100, 1000)
    bar(1, 100, -1)
    lines = capsys.readouterr().out.splitlines()
    assert lines == ['Downloading: {}%'.format(10 * i) for i in range(11)]
