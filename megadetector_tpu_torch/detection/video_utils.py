"""
Video frame decoding, frame extraction and frame-callback plumbing for the
port (counterpart of megadetector_tpu/detection/video_utils.py).

Frames are sampled with every_n_frames (negative: seconds, converted with
the stream's frame rate), named 'frame%06d.jpg', decoded by cv2 and
converted BGR -> RGB. A video that cannot be processed becomes a failure
record with frame rate -1, unless the failure is a kernel's, CUDA's or a
programming error (models/detector.py is_device_fault): those propagate.
The batched runner accumulates each video's decoded frames into batches
for the detector; a batch never spans two videos, and each video flushes
its tail. cv2 is required for video: opening one without it raises.

    python -m megadetector_tpu_torch.detection.video_utils videos frames \\
        [--every_n_frames 10]
"""

import json
import os
import re

from megadetector_tpu_torch.models.detector import (
    PROGRAMMING_ERRORS, is_device_fault, reraise_programming_errors)
from megadetector_tpu_torch.utils.ct_utils import (sort_list_of_dicts_by_key,
                                                   write_json)
from megadetector_tpu_torch.utils.path_utils import (  # noqa: F401
    VIDEO_EXTENSIONS, is_video_file, find_video_strings, find_videos)

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


#%% Frame naming


def _frame_number_to_filename(frame_number):
    """Synthetic, consistent frame identifier."""

    return 'frame{:06d}.jpg'.format(frame_number)


def _filename_to_frame_number(filename):
    """Inverse of _frame_number_to_filename."""

    filename = os.path.basename(filename)
    match = re.search(r'frame(\d+)\.jpg', filename)
    if match is None:
        raise ValueError(
            '{} does not appear to be a frame file'.format(filename))
    return int(match.group(1))


#%% Video open / probe


def open_video(input_video_file, verbose=False):
    """
    Open a video; returns (cv2.VideoCapture or None, error string or None).
    """

    assert cv2 is not None, 'OpenCV is required for video processing'
    if not os.path.isfile(input_video_file):
        return None, 'File {} not found'.format(input_video_file)
    vidcap = cv2.VideoCapture(input_video_file)
    if not vidcap.isOpened():
        return None, 'Could not open video {}'.format(input_video_file)
    return vidcap, None


def get_video_fs(input_video_file, verbose=False):
    """Frame rate of a video, or None on failure."""

    vidcap, error = open_video(input_video_file, verbose=verbose)
    if vidcap is None:
        return None
    fs = vidcap.get(cv2.CAP_PROP_FPS)
    vidcap.release()
    return fs


def _resolve_every_n_frames(every_n_frames, frame_rate):
    """
    Normalize the sampling parameter: None/0 -> 1 (every frame); negative
    values are seconds, converted via [frame_rate].
    """

    if every_n_frames is None:
        return 1
    if every_n_frames < 0:
        every_n_seconds = abs(every_n_frames)
        n = int(every_n_seconds * frame_rate)
        return max(n, 1)
    if every_n_frames == 0:
        return 1
    return int(every_n_frames)


#%% Frame iteration


def iterate_frames(input_video_file, every_n_frames=None,
                   frames_to_process=None, verbose=False):
    """
    Generator over sampled frames of a video. Yields
    (frame_number, rgb_numpy_array). Raises on open failure.

    Also usable for probing: next(iterate_frames(...)).
    """

    vidcap, error = open_video(input_video_file, verbose=verbose)
    if vidcap is None:
        raise IOError(error)

    try:
        frame_rate = vidcap.get(cv2.CAP_PROP_FPS)
        if every_n_frames is not None:
            every_n_frames = _resolve_every_n_frames(every_n_frames,
                                                     frame_rate)
        max_frame = None
        if frames_to_process is not None:
            frames_to_process = set(frames_to_process)
            max_frame = max(frames_to_process) if frames_to_process else -1

        frame_number = -1
        while True:
            success, image = vidcap.read()
            if not success:
                break
            frame_number += 1
            if every_n_frames is not None and \
                    (frame_number % every_n_frames) != 0:
                continue
            if frames_to_process is not None:
                if frame_number > max_frame:
                    break
                if frame_number not in frames_to_process:
                    continue
            yield frame_number, cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
    finally:
        vidcap.release()


def run_callback_on_frames(input_video_file, frame_callback,
                           every_n_frames=None, verbose=False,
                           frames_to_process=None, allow_empty_videos=False):
    """
    Run frame_callback(np_array, frame_id) on sampled frames of one video.

    Returns dict with 'frame_filenames', 'frame_rate', 'results'.
    """

    if isinstance(frames_to_process, int):
        frames_to_process = [frames_to_process]
    if frames_to_process is not None and every_n_frames is not None:
        raise ValueError(
            'frames_to_process and every_n_frames are mutually exclusive')

    frame_rate = get_video_fs(input_video_file)
    if frame_rate is None:
        raise IOError('Could not open video {}'.format(input_video_file))

    frame_filenames = []
    results = []
    for frame_number, image_np in iterate_frames(
            input_video_file, every_n_frames=every_n_frames,
            frames_to_process=frames_to_process, verbose=verbose):
        frame_id = _frame_number_to_filename(frame_number)
        frame_filenames.append(frame_id)
        results.append(frame_callback(image_np, frame_id))

    if len(frame_filenames) == 0 and not allow_empty_videos:
        raise ValueError(
            'No frames extracted from video {}'.format(input_video_file))

    return {'frame_filenames': frame_filenames,
            'frame_rate': frame_rate,
            'results': results}


def run_batched_callback_on_frames(input_video_file, batch_callback,
                                   every_n_frames=None, batch_size=8,
                                   verbose=False,
                                   allow_empty_videos=False):
    """
    Batched variant: batch_callback(list_of_np_arrays, list_of_frame_ids)
    -> list of per-frame results. Frames are accumulated to [batch_size]
    before dispatch so device batches stay full.
    """

    frame_rate = get_video_fs(input_video_file)
    if frame_rate is None:
        raise IOError('Could not open video {}'.format(input_video_file))

    frame_filenames = []
    results = []
    pending_imgs = []
    pending_ids = []

    def flush():
        if pending_imgs:
            results.extend(batch_callback(list(pending_imgs),
                                          list(pending_ids)))
            pending_imgs.clear()
            pending_ids.clear()

    for frame_number, image_np in iterate_frames(
            input_video_file, every_n_frames=every_n_frames,
            verbose=verbose):
        frame_id = _frame_number_to_filename(frame_number)
        frame_filenames.append(frame_id)
        pending_imgs.append(image_np)
        pending_ids.append(frame_id)
        if len(pending_imgs) >= batch_size:
            flush()
    flush()

    if len(frame_filenames) == 0 and not allow_empty_videos:
        raise ValueError(
            'No frames extracted from video {}'.format(input_video_file))

    return {'frame_filenames': frame_filenames,
            'frame_rate': frame_rate,
            'results': results}


def run_callback_on_frames_for_folder(input_video_folder, frame_callback,
                                      every_n_frames=None, verbose=False,
                                      recursive=True,
                                      files_to_process_relative=None,
                                      error_on_empty_video=False,
                                      batch_callback=None, batch_size=8):
    """
    Run a frame callback over every video in a folder. When
    [batch_callback] is given it is used instead of [frame_callback] via
    the batched runner.

    Returns dict with 'video_filenames' (relative paths), 'frame_rates',
    'results' (per video: list of per-frame results, or a {'failure': ...}
    dict with frame rate -1).
    """

    to_return = {'video_filenames': [], 'frame_rates': [], 'results': []}

    if files_to_process_relative is not None:
        input_files = [os.path.join(input_video_folder, fn).replace(
            '\\', '/') for fn in files_to_process_relative]
    else:
        input_files = find_videos(input_video_folder, recursive=recursive,
                                  convert_slashes=True,
                                  return_relative_paths=False)

    print('Processing {} videos from folder {}'.format(
        len(input_files), input_video_folder))
    if len(input_files) == 0:
        return to_return
    # Without cv2 every video would become a failure record below
    assert cv2 is not None, 'OpenCV is required for video processing'

    for i_video, video_fn_abs in enumerate(input_files):

        video_filename_relative = os.path.relpath(
            video_fn_abs, input_video_folder).replace('\\', '/')
        to_return['video_filenames'].append(video_filename_relative)

        try:
            if batch_callback is not None:
                video_results = run_batched_callback_on_frames(
                    input_video_file=video_fn_abs,
                    batch_callback=batch_callback,
                    every_n_frames=every_n_frames,
                    batch_size=batch_size,
                    verbose=verbose)
            else:
                video_results = run_callback_on_frames(
                    input_video_file=video_fn_abs,
                    frame_callback=frame_callback,
                    every_n_frames=every_n_frames,
                    verbose=verbose)
        except Exception as e:
            if is_device_fault(e) or (isinstance(e, PROGRAMMING_ERRORS) and
                                      reraise_programming_errors()):
                raise
            if not error_on_empty_video:
                print('Warning: error processing video {}: {}'.format(
                    video_fn_abs, e))
                to_return['frame_rates'].append(-1.0)
                to_return['results'].append(
                    {'failure': 'Failure processing video: {}'.format(e)})
                continue
            raise

        to_return['frame_rates'].append(video_results['frame_rate'])
        for r in video_results['results']:
            assert r['file'].startswith('frame')
            r['file'] = video_filename_relative + '/' + r['file']
        to_return['results'].append(video_results['results'])
        if verbose:
            print('Processed video {} of {}: {} frames'.format(
                i_video + 1, len(input_files),
                len(video_results['frame_filenames'])))

    return to_return


#%% Frame extraction to disk


def video_to_frames(input_video_file, output_folder, overwrite=True,
                    every_n_frames=None, verbose=False, quality=90,
                    max_width=None, allow_empty_videos=False):
    """
    Extract sampled frames of a video to JPEGs in [output_folder]. Returns
    (frame_filenames, frame_rate).
    """

    os.makedirs(output_folder, exist_ok=True)
    frame_rate = get_video_fs(input_video_file)
    if frame_rate is None:
        raise IOError('Could not open video {}'.format(input_video_file))

    frame_filenames = []
    for frame_number, image_np in iterate_frames(
            input_video_file, every_n_frames=every_n_frames,
            verbose=verbose):
        frame_fn = os.path.join(output_folder,
                                _frame_number_to_filename(frame_number))
        frame_filenames.append(frame_fn)
        if not overwrite and os.path.isfile(frame_fn):
            continue
        img = image_np
        if max_width is not None and img.shape[1] > max_width:
            scale = max_width / img.shape[1]
            img = cv2.resize(img, (max_width,
                                   int(round(img.shape[0] * scale))))
        cv2.imwrite(frame_fn, cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                    [int(cv2.IMWRITE_JPEG_QUALITY), quality])

    if len(frame_filenames) == 0 and not allow_empty_videos:
        raise ValueError(
            'No frames extracted from video {}'.format(input_video_file))

    return frame_filenames, frame_rate


def video_folder_to_frames(input_folder, output_folder_base, recursive=True,
                           overwrite=True, n_threads=1, every_n_frames=None,
                           verbose=False, quality=90, max_width=None,
                           allow_empty_videos=False):
    """
    Extract frames for every video under [input_folder] to per-video
    subfolders of [output_folder_base]. Returns
    (frame_filenames_by_video, fs_by_video, video_filenames).
    """

    input_files = find_videos(input_folder, recursive=recursive,
                              convert_slashes=True,
                              return_relative_paths=False)

    frame_filenames_by_video = []
    fs_by_video = []

    def _one(video_fn):
        relative = os.path.relpath(video_fn, input_folder).replace('\\', '/')
        out_dir = os.path.join(output_folder_base, relative)
        try:
            return video_to_frames(
                video_fn, out_dir, overwrite=overwrite,
                every_n_frames=every_n_frames, verbose=verbose,
                quality=quality, max_width=max_width,
                allow_empty_videos=allow_empty_videos)
        except Exception as e:
            print('Warning: error extracting frames from {}: {}'.format(
                video_fn, e))
            return [], -1.0

    if n_threads <= 1:
        outputs = [_one(fn) for fn in input_files]
    else:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            outputs = list(pool.map(_one, input_files))

    for frame_filenames, fs in outputs:
        frame_filenames_by_video.append(frame_filenames)
        fs_by_video.append(fs)

    return frame_filenames_by_video, fs_by_video, input_files


def frames_to_video(images, fs, output_file_name, codec_spec='mp4v'):
    """
    Encode a list of image files into a video at [fs] fps.
    """

    assert cv2 is not None, 'OpenCV is required for video processing'
    if len(images) == 0:
        return

    first = cv2.imread(images[0])
    height, width = first.shape[:2]
    os.makedirs(os.path.dirname(os.path.abspath(output_file_name)),
                exist_ok=True)
    fourcc = cv2.VideoWriter_fourcc(*codec_spec)
    out = cv2.VideoWriter(output_file_name, fourcc, fs, (width, height))
    try:
        for fn in images:
            frame = cv2.imread(fn)
            out.write(frame)
    finally:
        out.release()


#%% Frame results -> video results


class FrameToVideoOptions:
    """Options controlling frame_results_to_video_results()."""

    def __init__(self):
        #: One-indexed indicator of which frame-level confidence value
        #: determines each category's video-level detection, i.e. 1
        #: means "use the highest-confidence frame"
        self.nth_highest_confidence = 1
        #: Keep every processed frame's detections (with frame_number)
        #: rather than one canonical detection per category
        self.include_all_processed_frames = False
        #: 'error' or 'skip_with_warning' for results entries whose
        #: parent folder is not a video
        self.non_video_behavior = 'error'
        #: Require a frame rate for every video
        self.frame_rates_are_required = False
        self.verbose = False


def frame_results_to_video_results(input_file, output_file,
                                   options=None,
                                   video_filename_to_frame_rate=None,
                                   fs_default=None):
    """
    Convert an MD results file computed on frame images (named
    video/frame%06d.jpg) into a video-level results file. By default each
    video keeps one canonical detection per category, chosen by
    options.nth_highest_confidence; options.include_all_processed_frames
    keeps every frame's detections instead (every detection carries its
    frame_number either way). Also populates the repo's video fields:
    frame_rate (from [video_filename_to_frame_rate], else [fs_default],
    else -1), frames_processed, and per-video failure propagation.
    """

    if options is None:
        options = FrameToVideoOptions()

    if options.frame_rates_are_required:
        assert video_filename_to_frame_rate is not None, \
            'You specified that frame rates are required, but did not ' \
            'supply video_filename_to_frame_rate'

    with open(input_file) as f:
        data = json.load(f)

    detection_categories = data.get('detection_categories', {})

    video_to_frames_map = {}
    for im in data['images']:
        fn = im['file']
        video_name = os.path.dirname(fn).replace('\\', '/')
        if not is_video_file(video_name):
            if options.non_video_behavior == 'error':
                raise ValueError(
                    '{} is not a video file'.format(video_name))
            elif options.non_video_behavior == 'skip_with_warning':
                print('Warning: {} is not a video file'.format(
                    video_name))
                continue
            else:
                raise ValueError(
                    'Unrecognized non-video handling behavior: '
                    '{}'.format(options.non_video_behavior))
        video_to_frames_map.setdefault(video_name, []).append(im)

    video_images = []
    for video_name, frames in video_to_frames_map.items():
        im_out = {'file': video_name}
        frame_rate = None
        if video_filename_to_frame_rate is not None:
            frame_rate = video_filename_to_frame_rate.get(video_name)
            if frame_rate is None:
                s = 'Could not determine frame rate for {}'.format(
                    video_name)
                if options.frame_rates_are_required:
                    raise ValueError(s)
                elif options.verbose:
                    print('Warning: {}'.format(s))
        if frame_rate is None:
            frame_rate = fs_default if fs_default is not None else -1
        im_out['frame_rate'] = frame_rate
        im_out['frames_processed'] = []
        detections = []
        failed = False
        for frame_im in sort_list_of_dicts_by_key(frames, 'file'):
            frame_number = _filename_to_frame_number(frame_im['file'])
            im_out['frames_processed'].append(frame_number)
            if frame_im.get('detections') is None:
                failed = True
                im_out['failure'] = frame_im.get('failure',
                                                 'frame failure')
                continue
            for det in frame_im['detections']:
                det = dict(det)
                det['frame_number'] = frame_number
                detections.append(det)
        im_out['frames_processed'] = sorted(im_out['frames_processed'])

        if failed:
            im_out['detections'] = None
        elif options.include_all_processed_frames:
            im_out['detections'] = detections
        else:
            # One canonical detection per category, by
            # nth-highest confidence
            canonical_detections = []
            for category_id in detection_categories:
                category_detections = [d for d in detections
                                       if d['category'] == category_id]
                if len(category_detections) >= \
                        options.nth_highest_confidence:
                    by_confidence = sorted(category_detections,
                                           key=lambda d: d['conf'],
                                           reverse=True)
                    canonical_detections.append(
                        by_confidence[options.nth_highest_confidence
                                      - 1])
            im_out['detections'] = canonical_detections
        video_images.append(im_out)

    data['images'] = sort_list_of_dicts_by_key(video_images, 'file')
    write_json(output_file, data, force_str=True)
    return data


def main(argv=None):
    """CLI: extract sampled frames from a video or a video folder."""

    import argparse
    import sys

    parser = argparse.ArgumentParser(
        description='Extract sampled frames from video(s) to JPEGs')
    parser.add_argument('input_path',
                        help='a video file or a folder of videos')
    parser.add_argument('output_folder')
    parser.add_argument('--every_n_frames', type=float, default=None,
                        help='sample every Nth frame (negative: every '
                             'N seconds)')
    parser.add_argument('--quality', type=int, default=90)
    parser.add_argument('--max_width', type=int, default=None)
    parser.add_argument('--n_threads', type=int, default=1)
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args(argv)

    if os.path.isdir(args.input_path):
        video_folder_to_frames(
            args.input_path, args.output_folder,
            every_n_frames=args.every_n_frames, quality=args.quality,
            max_width=args.max_width, n_threads=args.n_threads)
    else:
        video_to_frames(
            args.input_path, args.output_folder,
            every_n_frames=args.every_n_frames, quality=args.quality,
            max_width=args.max_width)


if __name__ == '__main__':
    main()
