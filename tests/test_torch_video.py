"""
The port's video entry points and the results validator, on the CPU,
against the JAX package in the same process:

- detection/video_utils.py: frame naming, iterate_frames (BGR -> RGB,
  every_n_frames, seconds as a negative every_n_frames, frames_to_process),
  the single and batched frame runners (a batch never spans two videos,
  each video flushes its tail), the folder runner with a corrupt video,
  frame extraction to disk, frames_to_video, frame_results_to_video_results
  on each option; a kernel or CUDA fault in the batch callback propagates
  instead of becoming a failed video;
- detection/process_video.py on the same yolov5n .npz (torch_port_data's
  sharpened parameters) and videos written with cv2 (mp4v), frame_sample
  and time_sample: the JSON at the golden tolerances frame by frame, with
  identical video fields; options_to_command and the CLI;
- workflows/manage_video_batch.py (frames on disk, then the batch driver);
- postprocessing/validate_batch_results.py on good and malformed files:
  the same errors and warnings as the JAX package, and its CLI.
"""

import json
import os

import numpy as np
import pytest
import torch

from megadetector_tpu.detection import process_video as jax_process_video
from megadetector_tpu.detection import video_utils as jax_video
from megadetector_tpu.postprocessing import \
    validate_batch_results as jax_validate
from megadetector_tpu.utils import md_tests
from megadetector_tpu.workflows import manage_video_batch as jax_manage
from megadetector_tpu_torch.detection import process_video, video_utils
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.ops._build import KernelError
from megadetector_tpu_torch.postprocessing import validate_batch_results
from megadetector_tpu_torch.workflows import manage_video_batch

import torch_port_data as data

cv2 = pytest.importorskip('cv2')

VIDEOS = [('vid_a.mp4', 12, 6.0), ('sub/vid_b.avi', 8, 4.0)]
FRAME_HW = (120, 160)


@pytest.fixture(scope='module')
def video_inputs(tmp_path_factory):
    """(root, model, video folder): two videos of noisy frames made from
    torch_port_data's images (so the sharpened model detects in them), in
    two folders, and one corrupt file."""

    root = tmp_path_factory.mktemp('video')
    images = data.images()
    model = str(root / 'md_v5a.0.0_test.npz')
    save_checkpoint(data.sharpened_params(images), model, data.METADATA)
    folder = root / 'videos'
    (folder / 'sub').mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i_video, (name, n_frames, fps) in enumerate(VIDEOS):
        codec = 'mp4v' if name.endswith('.mp4') else 'MJPG'
        out = cv2.VideoWriter(str(folder / name),
                              cv2.VideoWriter_fourcc(*codec), fps,
                              FRAME_HW[::-1])
        assert out.isOpened()
        base = cv2.resize(images[i_video], FRAME_HW[::-1])
        for _ in range(n_frames):
            frame = np.clip(base.astype(np.int32) +
                            rng.randint(-24, 24, base.shape), 0, 255)
            out.write(frame.astype(np.uint8)[..., ::-1].copy())
        out.release()
    with open(str(folder / 'corrupt.mp4'), 'wb') as f:
        f.write(b'not a video')
    return root, model, str(folder)


def _video(video_inputs, i=0):
    return os.path.join(video_inputs[2], VIDEOS[i][0])


#%% video_utils


def test_frame_naming_matches_jax():
    for n in (0, 7, 123456, 1000000):
        name = video_utils._frame_number_to_filename(n)
        assert name == jax_video._frame_number_to_filename(n)
        assert video_utils._filename_to_frame_number('v.mp4/' + name) == n
    for bad in ('notaframe.jpg', 'frame12.png'):
        for fn in (video_utils._filename_to_frame_number,
                   jax_video._filename_to_frame_number):
            with pytest.raises(ValueError):
                fn(bad)


@pytest.mark.parametrize('every_n_frames,frames', [
    (None, None), (3, None), (-1.0, None), (-0.25, None), (0, None),
    (None, [0, 5, 11, 40]), (None, 4)])
def test_iterate_frames_matches_jax(video_inputs, every_n_frames, frames):
    path = _video(video_inputs)
    frames_list = [frames] if isinstance(frames, int) else frames
    ours = list(video_utils.iterate_frames(
        path, every_n_frames=every_n_frames, frames_to_process=frames_list))
    ref = list(jax_video.iterate_frames(
        path, every_n_frames=every_n_frames, frames_to_process=frames_list))
    assert [n for n, _ in ours] == [n for n, _ in ref]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(ours, ref))
    assert ours[0][1].shape == FRAME_HW + (3,)
    # RGB: the first frame as cv2 decodes it, channels reversed
    cap = cv2.VideoCapture(path)
    _, bgr = cap.read()
    cap.release()
    if ours[0][0] == 0:
        assert np.array_equal(ours[0][1], bgr[..., ::-1])
    calls = []
    out = video_utils.run_callback_on_frames(
        path, lambda img, fid: calls.append(fid) or {'file': fid},
        every_n_frames=every_n_frames, frames_to_process=frames)
    assert out['frame_filenames'] == calls == [
        video_utils._frame_number_to_filename(n) for n, _ in ours]
    assert out['frame_rate'] == pytest.approx(6.0, abs=0.1)


def test_sampling_cases_of_the_jax_tests(video_inputs):
    """tests/test_video_and_tiled.py's cases: every 3rd frame of 12 is
    0, 3, 6, 9; one second at 6 fps is every 6th frame; frames_to_process
    with every_n_frames raises; get_video_fs."""

    path = _video(video_inputs)
    seen = []
    video_utils.run_callback_on_frames(
        path, lambda img, fid: seen.append(fid), every_n_frames=3)
    assert seen == ['frame000000.jpg', 'frame000003.jpg',
                    'frame000006.jpg', 'frame000009.jpg']
    seen.clear()
    video_utils.run_callback_on_frames(
        path, lambda img, fid: seen.append(fid), every_n_frames=-1.0)
    assert seen == ['frame000000.jpg', 'frame000006.jpg']
    with pytest.raises(ValueError, match='mutually exclusive'):
        video_utils.run_callback_on_frames(path, None, every_n_frames=2,
                                           frames_to_process=[1])
    assert video_utils.get_video_fs(path) == jax_video.get_video_fs(path)
    assert video_utils.get_video_fs('missing.mp4') is None
    with pytest.raises(IOError):
        next(video_utils.iterate_frames(os.path.join(video_inputs[2],
                                                     'corrupt.mp4')))


def test_video_needs_cv2(video_inputs, monkeypatch):
    """cv2 is imported behind a try, as in the JAX package, but opening or
    writing a video without it raises instead of skipping the video."""

    monkeypatch.setattr(video_utils, 'cv2', None)
    with pytest.raises(AssertionError, match='OpenCV'):
        video_utils.open_video(_video(video_inputs))
    with pytest.raises(AssertionError, match='OpenCV'):
        video_utils.frames_to_video(['a.jpg'], 30.0, 'out.mp4')
    with pytest.raises(AssertionError, match='OpenCV'):
        video_utils.run_callback_on_frames_for_folder(
            video_inputs[2], None, batch_callback=lambda i, d: [])


def _batch_recorder(log):
    def batch_callback(images, ids):
        log.append((len(images), ids[0], ids[-1]))
        assert all(img.shape == FRAME_HW + (3,) for img in images)
        return [{'file': i, 'detections': []} for i in ids]
    return batch_callback


@pytest.mark.parametrize('every_n_frames,batch_size', [(None, 4), (2, 4),
                                                       (None, 5), (-1.0, 8)])
def test_folder_runner_matches_jax(video_inputs, every_n_frames,
                                   batch_size):
    """Batches never span two videos and each video flushes its tail; the
    corrupt video is a failure record with frame rate -1; the output
    equals the JAX package's."""

    folder = video_inputs[2]
    logs = ([], [])
    outs = [module.run_callback_on_frames_for_folder(
        folder, None, every_n_frames=every_n_frames,
        batch_callback=_batch_recorder(log), batch_size=batch_size)
        for module, log in zip((video_utils, jax_video), logs)]
    assert outs[0] == outs[1]
    assert logs[0] == logs[1]
    assert outs[0]['video_filenames'] == ['corrupt.mp4', 'sub/vid_b.avi',
                                          'vid_a.mp4']
    assert outs[0]['frame_rates'][0] == -1.0
    assert outs[0]['results'][0]['failure'].startswith(
        'Failure processing video')
    for n, first, last in logs[0]:
        assert n <= batch_size and first[:5] == last[:5] == 'frame'
    step = {None: 1, 2: 2, -1.0: None}[every_n_frames]
    for (name, n_frames, fps), results in zip(VIDEOS[::-1],
                                              outs[0]['results'][1:]):
        every = step or int(fps)
        assert [r['file'] for r in results] == [
            '{}/frame{:06d}.jpg'.format(name, i)
            for i in range(0, n_frames, every)]
    # per video: full batches, then its own tail
    want = []
    for results in outs[0]['results'][1:]:
        n = len(results)
        want += [batch_size] * (n // batch_size) + [n % batch_size] * (
            n % batch_size > 0)
    assert [n for n, _, _ in logs[0]] == want
    # the single-frame runner gives the same records
    single = video_utils.run_callback_on_frames_for_folder(
        folder, lambda img, fid: {'file': fid, 'detections': []},
        every_n_frames=every_n_frames, files_to_process_relative=[
            'vid_a.mp4'])
    assert single['results'] == [outs[0]['results'][2]]


@pytest.mark.parametrize('fault', [
    KernelError('bottleneck_int8 launch failed'),
    RuntimeError('CUDA error: device-side assert triggered'),
    torch.cuda.OutOfMemoryError('CUDA out of memory')])
def test_device_faults_in_the_batch_callback_propagate(video_inputs, fault):
    """The folder runner contains a video's data errors as failure
    records, never a kernel's or CUDA's fault."""

    def callback(images, ids):
        raise fault

    with pytest.raises(type(fault)):
        video_utils.run_callback_on_frames_for_folder(
            video_inputs[2], None, batch_callback=callback)

    def data_error(images, ids):
        raise ValueError('bad frames')

    out = video_utils.run_callback_on_frames_for_folder(
        video_inputs[2], None, batch_callback=data_error)
    assert out['frame_rates'] == [-1.0] * 3
    assert [r['failure'] for r in out['results']][1:] == [
        'Failure processing video: bad frames'] * 2
    with pytest.raises(OSError, match='Could not open'):
        video_utils.run_callback_on_frames_for_folder(
            video_inputs[2], None, batch_callback=data_error,
            error_on_empty_video=True)


def test_video_to_frames_matches_jax(video_inputs, tmp_path):
    for module, name in ((video_utils, 'ours'), (jax_video, 'ref')):
        frames, fs = module.video_to_frames(
            _video(video_inputs, 1), str(tmp_path / name / 'b'),
            every_n_frames=2, quality=85, max_width=100)
        assert [os.path.basename(f) for f in frames] == [
            'frame000000.jpg', 'frame000002.jpg', 'frame000004.jpg',
            'frame000006.jpg']
        assert fs == pytest.approx(4.0, abs=0.1)
        module.video_folder_to_frames(video_inputs[2],
                                      str(tmp_path / name / 'all'),
                                      every_n_frames=5, n_threads=2,
                                      allow_empty_videos=True)
    for sub in ('b', 'all/vid_a.mp4', 'all/sub/vid_b.avi'):
        names = sorted(os.listdir(str(tmp_path / 'ours' / sub)))
        assert names == sorted(os.listdir(str(tmp_path / 'ref' / sub)))
        for n in names:
            with open(str(tmp_path / 'ours' / sub / n), 'rb') as a, \
                    open(str(tmp_path / 'ref' / sub / n), 'rb') as b:
                assert a.read() == b.read()
    img = cv2.imread(str(tmp_path / 'ours' / 'b' / 'frame000000.jpg'))
    assert img.shape == (75, 100, 3)
    out = str(tmp_path / 'rebuilt.mp4')
    video_utils.frames_to_video(
        sorted(str(tmp_path / 'ours' / 'b' / n)
               for n in os.listdir(str(tmp_path / 'ours' / 'b'))), 2.0, out)
    assert len(list(video_utils.iterate_frames(out))) == 4
    video_utils.main([_video(video_inputs), str(tmp_path / 'cli'),
                      '--every_n_frames', '4'])
    assert sorted(os.listdir(str(tmp_path / 'cli'))) == [
        'frame000000.jpg', 'frame000004.jpg', 'frame000008.jpg']


def _frame_results(tmp_path):
    frame_data = {
        'images': [
            {'file': 'v1.mp4/frame000000.jpg', 'detections': [
                {'category': '1', 'conf': 0.9, 'bbox': [0.1, 0.1, 0.2, 0.2]},
                {'category': '2', 'conf': 0.3,
                 'bbox': [0.5, 0.1, 0.2, 0.2]}]},
            {'file': 'v1.mp4/frame000004.jpg', 'detections': [
                {'category': '1', 'conf': 0.7,
                 'bbox': [0.2, 0.1, 0.2, 0.2]}]},
            {'file': 'v2.avi/frame000000.jpg', 'detections': []},
            {'file': 'a/v3.mp4/frame000008.jpg', 'detections': None,
             'failure': 'image access failure'},
            {'file': 'a/v3.mp4/frame000002.jpg', 'detections': []},
            {'file': 'images/not_a_video.jpg', 'detections': []},
        ],
        'detection_categories': {'1': 'animal', '2': 'person'},
        'info': {'format_version': '1.6'},
    }
    path = str(tmp_path / 'frames.json')
    with open(path, 'w') as f:
        json.dump(frame_data, f)
    return path


@pytest.mark.parametrize('case', ['canonical', 'all_frames', 'second',
                                  'skip', 'error', 'rates', 'rates_needed'])
def test_frame_results_to_video_results_matches_jax(tmp_path, case):
    path = _frame_results(tmp_path)
    outs = []
    for module in (video_utils, jax_video):
        options = module.FrameToVideoOptions()
        options.non_video_behavior = 'skip_with_warning'
        kwargs = {'fs_default': 5.0}
        if case == 'all_frames':
            options.include_all_processed_frames = True
        elif case == 'second':
            options.nth_highest_confidence = 2
        elif case == 'error':
            options.non_video_behavior = 'error'
        elif case == 'rates':
            kwargs = {'video_filename_to_frame_rate': {'v1.mp4': 30.0}}
        elif case == 'rates_needed':
            options.frame_rates_are_required = True
            kwargs = {'video_filename_to_frame_rate': {'v1.mp4': 30.0}}
        out_file = str(tmp_path / (module.__name__ + '.json'))
        if case in ('error', 'rates_needed'):
            with pytest.raises(ValueError):
                module.frame_results_to_video_results(path, out_file,
                                                      options, **kwargs)
            continue
        outs.append(module.frame_results_to_video_results(
            path, out_file, options, **kwargs))
        with open(out_file) as f:
            assert json.load(f) == outs[-1]
    if outs:
        assert outs[0] == outs[1]
        by_file = {im['file']: im for im in outs[0]['images']}
        assert by_file['a/v3.mp4']['detections'] is None
        assert by_file['a/v3.mp4']['frames_processed'] == [2, 8]


#%% process_video


def _per_frame(out):
    """Video records -> one image dict per processed frame, so detections
    are matched within their frame."""

    images = []
    for im in out['images']:
        for n in im['frames_processed']:
            images.append({'file': '{}/{}'.format(im['file'], n),
                           'detections': [
                               d for d in im['detections'] or []
                               if d['frame_number'] == n]})
    return {'images': images}


def _assert_same_videos(ours, ref):
    for out in (ours, ref):
        out['info'].pop('detection_completion_time', None)
    assert [im['file'] for im in ours['images']] == \
        [im['file'] for im in ref['images']]
    for a, b in zip(ours['images'], ref['images']):
        assert {k: v for k, v in a.items() if k != 'detections'} == \
            {k: v for k, v in b.items() if k != 'detections'}
        assert (a['detections'] is None) == (b['detections'] is None)
    result = md_tests.compare_results(_per_frame(ref), _per_frame(ours),
                                      data.golden_options())
    assert result['errors'] == [], result['errors'][:5]
    return result['n_images_compared']


@pytest.mark.parametrize('sampling', [('frame_sample', 4),
                                      ('time_sample', 0.5)])
def test_process_videos_matches_jax(video_inputs, tmp_path, sampling):
    root, model, folder = video_inputs
    outs = []
    for module in (process_video, jax_process_video):
        options = module.ProcessVideoOptions()
        options.model_file = model
        options.input_video_file = folder
        options.output_json_file = str(tmp_path / (module.__name__ +
                                                   '.json'))
        setattr(options, sampling[0], sampling[1])
        options.frame_batch_size = 3
        options.image_size = 128
        if module is process_video:
            options.device = 'cpu'
        else:
            options.detector_options = {'force_cpu': 'true'}
        outs.append(module.process_videos(options))
    by_file = {im['file']: im for im in outs[0]['images']}
    assert set(by_file) == {'corrupt.mp4', 'sub/vid_b.avi', 'vid_a.mp4'}
    corrupt = by_file['corrupt.mp4']
    assert corrupt['detections'] is None and corrupt['frame_rate'] == -1.0
    assert corrupt['failure'].startswith('Failure processing video')
    want = {'frame_sample': ([0, 4, 8], [0, 4]),
            'time_sample': ([0, 3, 6, 9], [0, 2, 4, 6])}[sampling[0]]
    assert by_file['vid_a.mp4']['frames_processed'] == want[0]
    assert by_file['sub/vid_b.avi']['frames_processed'] == want[1]
    for im in (by_file['vid_a.mp4'], by_file['sub/vid_b.avi']):
        assert len(im['detections']) > 0
        assert {d['frame_number'] for d in im['detections']} <= \
            set(im['frames_processed'])
    assert _assert_same_videos(*outs) == len(want[0]) + len(want[1])


def test_process_video_single_file_and_cli(video_inputs, tmp_path,
                                           monkeypatch):
    root, model, folder = video_inputs
    options = process_video.ProcessVideoOptions()
    options.model_file = model
    options.input_video_file = _video(video_inputs)
    options.frame_sample = 5
    options.image_size = 128
    options.device = 'cpu'
    out = process_video.process_video(options)
    assert options.output_json_file == _video(video_inputs) + '.json'
    assert [im['file'] for im in out['images']] == ['vid_a.mp4']
    assert out['images'][0]['frames_processed'] == [0, 5, 10]

    args = [model, folder, '--output_json_file', str(tmp_path / 'cli.json'),
            '--frame_sample', '6', '--image_size', '128',
            '--frame_batch_size', '2', '--no-recursive']
    ours = process_video.main(args + ['--device', 'cpu'])
    monkeypatch.setattr('sys.argv', ['process_video'] + args[:3] + [
        str(tmp_path / 'cli_ref.json')] + args[4:] + [
        '--detector_options', 'force_cpu=true'])
    jax_process_video.main()
    with open(str(tmp_path / 'cli_ref.json')) as f:
        ref = json.load(f)
    assert [im['file'] for im in ours['images']] == ['corrupt.mp4',
                                                     'vid_a.mp4']
    _assert_same_videos(ours, ref)


@pytest.mark.parametrize('case', ['default', 'time', 'no_recursive',
                                  'options'])
def test_options_to_command_matches_jax(case):
    commands = []
    for module in (process_video, jax_process_video):
        options = module.ProcessVideoOptions()
        options.model_file = 'model.npz'
        options.input_video_file = 'videos'
        if case == 'time':
            options.time_sample = 0.5
            options.output_json_file = 'out.json'
            options.frame_batch_size = 16
        elif case == 'no_recursive':
            options.recursive = False
            options.frame_sample = 3
            options.verbose = True
        elif case == 'options':
            options.detector_options = {'dtype': 'bf16',
                                        'conv_backend': 'pallas'}
            options.image_size = 960
        commands.append(module.options_to_command(options))
    assert commands[0] == commands[1].replace(
        'megadetector_tpu.detection', 'megadetector_tpu_torch.detection')
    options = process_video.ProcessVideoOptions()
    options.input_video_file = 'videos'
    options.device = 'cpu'
    assert process_video.options_to_command(options).endswith(
        ' --device cpu')


def test_process_video_faults_propagate(video_inputs, tmp_path,
                                        monkeypatch):
    """A kernel fault in the detector's batch propagates out of
    process_videos; device None means CUDA."""

    root, model, folder = video_inputs
    from megadetector_tpu_torch.detection import run_detector
    detector = run_detector.load_detector(model, device='cpu')

    def fail(*args, **kwargs):
        raise KernelError('l0_fused launch failed')

    monkeypatch.setattr(detector, '_run_batch', fail)
    options = process_video.ProcessVideoOptions()
    options.model_file = detector
    options.input_video_file = folder
    options.output_json_file = str(tmp_path / 'fault.json')
    with pytest.raises(KernelError):
        process_video.process_videos(options)
    if not torch.cuda.is_available():
        options.model_file = model
        with pytest.raises(RuntimeError, match='CUDA'):
            process_video.process_videos(options)


#%% manage_video_batch


def test_process_video_folder_via_frames_matches_jax(video_inputs, tmp_path):
    """Frames to disk, the batch driver, then video records: the JAX
    package's JSON, and the frame numbers and frame rates of the direct
    path (whose detections differ: it reads no JPEG)."""

    root, model, folder = video_inputs
    outs = []
    for module, name in ((manage_video_batch, 'ours'), (jax_manage, 'ref')):
        options = module.VideoBatchOptions()
        options.model_file = model
        options.input_video_folder = folder
        options.frame_folder = str(tmp_path / ('frames_' + name))
        options.output_json_file = str(tmp_path / (name + '.json'))
        options.every_n_frames = 4
        options.batch_size = 4
        options.image_size = 128
        if module is manage_video_batch:
            options.device = 'cpu'
        else:
            options.detector_options = {'force_cpu': 'true',
                                        'use_mesh': 'false'}
        outs.append(module.process_video_folder_via_frames(options))
        assert not os.path.exists(options.frame_folder)
    assert [im['file'] for im in outs[0]['images']] == ['sub/vid_b.avi',
                                                        'vid_a.mp4']
    assert _assert_same_videos(*outs) == 5
    direct = process_video.ProcessVideoOptions()
    direct.model_file = model
    direct.input_video_file = folder
    direct.output_json_file = str(tmp_path / 'direct.json')
    direct.frame_sample = 4
    direct.device = 'cpu'
    direct.image_size = 128
    by_file = {im['file']: im for im in
               process_video.process_videos(direct)['images']}
    for im in outs[0]['images']:
        assert im['frames_processed'] == \
            by_file[im['file']]['frames_processed']
        assert im['frame_rate'] == by_file[im['file']]['frame_rate']

    args = [folder, str(tmp_path / 'cli_frames'), str(tmp_path / 'cli.json'),
            '--model_file', model, '--every_n_frames', '6', '--keep_frames',
            '--device', 'cpu']
    cli = manage_video_batch.main(args)
    assert [im['frames_processed'] for im in cli['images']] == [[0, 6],
                                                                [0, 6]]
    assert os.path.isdir(str(tmp_path / 'cli_frames' / 'vid_a.mp4'))


#%% validate_batch_results


def _good_results():
    return {
        'info': {'format_version': '1.6', 'detector': 'md_v5a.0.0.pt'},
        'detection_categories': {'1': 'animal', '2': 'person'},
        'classification_categories': {'0': 'deer', '1': 'fox'},
        'images': [
            {'file': 'a.jpg', 'detections': [
                {'category': '1', 'conf': 0.9, 'bbox': [0.1, 0.1, 0.2, 0.2],
                 'classifications': [['0', 0.8], ['1', 0.1]]},
                {'category': '2', 'conf': -0.4,
                 'bbox': [0.5, 0.5, 0.2, 0.2]}]},
            {'file': 'b.jpg', 'detections': None,
             'failure': 'image access failure'},
            {'file': 'v.mp4', 'frame_rate': 30.0, 'frames_processed': [0, 4],
             'detections': [{'category': '1', 'conf': 0.5,
                             'bbox': [0.2, 0.2, 0.1, 0.1],
                             'frame_number': 4}]},
            {'file': 'c.jpg', 'detections': []},
        ]}


MALFORMED = {
    'no_images': lambda d: d.pop('images'),
    'no_info': lambda d: d.pop('info'),
    'no_version': lambda d: d['info'].pop('format_version'),
    'category_id': lambda d: d['detection_categories'].update({'x': 'a'}),
    'category_name': lambda d: d['detection_categories'].update({'3': 3}),
    'no_file': lambda d: d['images'][0].pop('file'),
    'duplicate': lambda d: d['images'].append(dict(d['images'][3])),
    'failure_and_detections': lambda d: d['images'][1].update(
        detections=[]),
    'null_detections': lambda d: d['images'][3].update(detections=None),
    'frame_rate': lambda d: d['images'][2].update(frame_rate='30'),
    'frames_processed': lambda d: d['images'][2].update(
        frames_processed=4),
    'detection_fields': lambda d: d['images'][0]['detections'][0].pop(
        'conf'),
    'unknown_category': lambda d: d['images'][0]['detections'][0].update(
        category='7'),
    'confidence': lambda d: d['images'][0]['detections'][0].update(
        conf=1.5),
    'bbox': lambda d: d['images'][0]['detections'][0].update(
        bbox=[0.1, 0.2]),
    'outside': lambda d: d['images'][0]['detections'][0].update(
        bbox=[0.9, 0.9, 0.3, 0.3]),
    'frame_number': lambda d: d['images'][2]['detections'][0].update(
        frame_number=8),
    'classification': lambda d: d['images'][0]['detections'][0].update(
        classifications=[['0']]),
    'classification_category': lambda d: d['images'][0]['detections'][
        0].update(classifications=[['9', 0.5]]),
}


@pytest.mark.parametrize('case', ['good'] + sorted(MALFORMED))
def test_validate_batch_results_matches_jax(tmp_path, case):
    results = _good_results()
    if case != 'good':
        MALFORMED[case](results)
    path = str(tmp_path / 'results.json')
    with open(path, 'w') as f:
        json.dump(results, f)
    outs = []
    for module in (validate_batch_results, jax_validate):
        options = module.ValidateBatchResultsOptions()
        options.return_data = True
        options.verbose = True
        outs.append(module.validate_batch_results(path, options))
    assert outs[0] == outs[1]
    errors = outs[0]['validation_results']['validation_errors']
    warnings = outs[0]['validation_results']['validation_warnings']
    assert (errors == []) == (case in ('good', 'outside'))
    assert (warnings != []) == (case == 'outside')
    if errors:
        raised = []
        for module in (validate_batch_results, jax_validate):
            options = module.ValidateBatchResultsOptions()
            options.raise_errors = True
            with pytest.raises(ValueError) as e:
                module.validate_batch_results(path, options)
            raised.append(str(e.value))
        assert raised[0] == raised[1] == errors[0]


def test_validate_image_existence_and_cli(tmp_path, capsys):
    results = _good_results()
    path = str(tmp_path / 'results.json')
    with open(path, 'w') as f:
        json.dump(results, f)
    (tmp_path / 'a.jpg').write_bytes(b'')
    outs = []
    for module in (validate_batch_results, jax_validate):
        options = module.ValidateBatchResultsOptions()
        options.check_image_existence = True
        outs.append(module.validate_batch_results(path, options))
    assert outs[0] == outs[1]
    assert len(outs[0]['validation_results']['validation_errors']) == 2
    assert validate_batch_results.main([path]) is None
    assert 'Validation successful' in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        validate_batch_results.main([path, '--check_image_existence'])
    assert e.value.code == 1
    assert 'Validation failed with 2 errors' in capsys.readouterr().out
