"""
Standalone frame-extraction CLI: write sampled (or detector-referenced)
frames of a video or a folder of videos to JPEG files.

Reference behavior (megadetector/utils/extract_frames_from_video.py:
1-307): a single video writes frames into the destination folder; a
folder of videos writes per-video subfolders. Sampling is every Nth
frame (frame_sample > 1), every frame (None/1), or every N seconds
(negative frame_sample) — or, with detector_output_file, exactly the
frames referenced by an MD results file's detections (mutually
exclusive with frame_sample; source must then be a folder).

The port's copy of megadetector_tpu/utils/extract_frames_from_video.py, on
the port's detection/video_utils (cv2 decodes; no device code).
"""

import argparse
import json
import os
import sys

from megadetector_tpu_torch.detection.video_utils import (
    is_video_file, iterate_frames, video_to_frames,
    video_folder_to_frames, _frame_number_to_filename)
from megadetector_tpu_torch.utils import ct_utils


class FrameExtractionOptions:
    """Parameters controlling extract_frames()."""

    def __init__(self):
        self.n_workers = 1
        self.parallelize_with_threads = False
        self.quality = 80
        self.max_width = None
        self.verbose = False

        # Every Nth frame (None/1 = every frame; negative = a sampling
        # rate in seconds). Mutually exclusive with
        # detector_output_file.
        self.frame_sample = None

        # MD results file: extract exactly the frames its detections
        # reference (source must be a folder)
        self.detector_output_file = None


def _parse_detector_output(detector_output_file, source_folder,
                           verbose=False):
    """
    Map relative video paths to the sorted frame numbers their
    detections reference (reference: extract_frames_from_video.py:
    144-225). Returns (frames_by_video, relative_paths).
    """

    with open(detector_output_file) as f:
        data = json.load(f)

    frames_by_video = {}
    for im in data['images']:
        if im.get('detections') is None:
            continue
        if 'frames_processed' not in im and not any(
                'frame_number' in d for d in im['detections']):
            continue
        frames = sorted({d['frame_number'] for d in im['detections']
                         if 'frame_number' in d})
        if len(frames) == 0:
            continue
        rel = im['file'].replace('\\', '/')
        if not os.path.isfile(os.path.join(source_folder, rel)):
            if verbose:
                print('Skipping missing video {}'.format(rel))
            continue
        frames_by_video[rel] = frames

    print('Found {} videos with frames to extract'.format(
        len(frames_by_video)))
    return frames_by_video, sorted(frames_by_video.keys())


def _extract_specific_frames(video_file, output_folder, frame_numbers,
                             quality=80, max_width=None, verbose=False):
    """Extract exactly [frame_numbers] from one video."""

    import cv2

    os.makedirs(output_folder, exist_ok=True)
    written = []
    for frame_number, image_np in iterate_frames(
            video_file, frames_to_process=frame_numbers,
            verbose=verbose):
        img = image_np
        if max_width is not None and img.shape[1] > max_width:
            scale = max_width / img.shape[1]
            img = cv2.resize(
                img, (max_width, int(round(img.shape[0] * scale))))
        out_fn = os.path.join(output_folder,
                              _frame_number_to_filename(frame_number))
        cv2.imwrite(out_fn, cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                    [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
        written.append(out_fn)
    return written


def extract_frames(source, destination, options=None):
    """
    Extract frames from [source] (a video file or a folder of videos)
    into [destination]. Returns a summary dict.
    """

    if options is None:
        options = FrameExtractionOptions()
    assert not (options.frame_sample is not None and
                options.detector_output_file is not None), \
        'frame_sample and detector_output_file are mutually exclusive'

    every_n_frames = options.frame_sample
    if every_n_frames is not None and every_n_frames == 1:
        every_n_frames = None

    if os.path.isfile(source):
        assert is_video_file(source), \
            '{} is not a recognized video file'.format(source)
        assert options.detector_output_file is None, \
            'detector_output_file requires a folder source'
        frame_files, frame_rate = video_to_frames(
            source, destination, every_n_frames=every_n_frames,
            verbose=options.verbose, quality=options.quality,
            max_width=options.max_width)
        return {'n_videos': 1, 'n_frames': len(frame_files),
                'frame_rate': frame_rate}

    assert os.path.isdir(source), \
        'Source {} is neither a file nor a folder'.format(source)

    if options.detector_output_file is not None:
        frames_by_video, rel_paths = _parse_detector_output(
            options.detector_output_file, source,
            verbose=options.verbose)
        n_frames = 0
        for rel in rel_paths:
            written = _extract_specific_frames(
                os.path.join(source, rel),
                os.path.join(destination, rel),
                frames_by_video[rel],
                quality=options.quality, max_width=options.max_width,
                verbose=options.verbose)
            n_frames += len(written)
        return {'n_videos': len(rel_paths), 'n_frames': n_frames}

    frame_files_by_video, fs_by_video, video_files = \
        video_folder_to_frames(
            source, destination,
            n_threads=options.n_workers if
            options.parallelize_with_threads or options.n_workers > 1
            else 1,
            every_n_frames=every_n_frames, verbose=options.verbose,
            quality=options.quality, max_width=options.max_width,
            allow_empty_videos=True)
    return {'n_videos': len(video_files),
            'n_frames': sum(len(ff) for ff in frame_files_by_video)}


def main():
    parser = argparse.ArgumentParser(
        description='Extract frames from a video or folder of videos')
    parser.add_argument('source',
                        help='video file or folder of videos')
    parser.add_argument('destination',
                        help='output folder for frame JPEGs')
    parser.add_argument('--n_workers', type=int, default=1)
    parser.add_argument('--parallelize_with_threads',
                        action='store_true')
    parser.add_argument('--quality', type=int, default=80)
    parser.add_argument('--max_width', type=int, default=None)
    parser.add_argument('--verbose', action='store_true')
    group = parser.add_mutually_exclusive_group()
    group.add_argument('--frame_sample', type=float, default=None,
                       help='every Nth frame; negative = every N '
                            'seconds')
    group.add_argument('--detector_output_file', type=str, default=None,
                       help='MD results file; extract the frames its '
                            'detections reference')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    options = FrameExtractionOptions()
    ct_utils.args_to_object(args, options)
    summary = extract_frames(args.source, args.destination, options)
    print('Extracted {} frames from {} videos'.format(
        summary['n_frames'], summary['n_videos']))


if __name__ == '__main__':
    main()
