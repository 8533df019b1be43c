"""
Render video-level detection results back onto videos: draw per-frame
boxes on the sampled frames and re-encode an annotated video (or frame
folder).

Behavioral contract follows the reference
(megadetector/visualization/visualize_video_output.py:623).

The port's own copy of
megadetector_tpu/visualization/visualize_video_output.py: the same
public names, signatures, defaults and output bytes; its progress bars
are plain loops.
"""

import argparse
import json
import os
import sys

from collections import defaultdict

from megadetector_tpu_torch.visualization import visualization_utils as vis_utils


class VideoVisualizationOptions:
    """
    Options controlling visualize_video_output() (reference:
    visualize_video_output.py:49-126).
    """

    def __init__(self):
        #: Confidence threshold for including detections
        self.confidence_threshold = 0.2
        #: Sample N videos to process (-1 for all videos)
        self.sample = -1
        #: Random seed for sampling (None keeps file order, taking the
        #: first N)
        self.random_seed = None
        #: Confidence threshold for including classification labels
        self.classification_confidence_threshold = 0.3
        #: Output frame rate: a float, or 'auto' to keep each video's
        #: native rate
        self.rendering_fs = 'auto'
        #: Fourcc codec specification for video encoding
        self.fourcc = 'mp4v'
        #: Skip frames before the first and after the last
        #: above-threshold detection
        self.trim_to_detections = False
        #: Render annotated frame folders instead of videos
        self.render_frames_only = False
        #: Flatten relative paths in the output folder...
        self.flatten_output = True
        #: ...replacing path separators with this string
        self.path_separator_replacement = '~'


def visualize_video_output(video_results_file, input_video_folder,
                           output_folder, options=None,
                           confidence_threshold=None,
                           fourcc=None, render_frames_only=None,
                           sample=None):
    """
    For each video in [video_results_file], draw its detections on the
    corresponding frames and write an annotated video (or frame folder)
    under [output_folder]. The keyword arguments are convenience
    overrides onto [options] (a VideoVisualizationOptions). Returns the
    list of outputs written.
    """

    import cv2
    import numpy as np
    from PIL import Image

    if options is None:
        options = VideoVisualizationOptions()
    if confidence_threshold is not None:
        options.confidence_threshold = confidence_threshold
    if fourcc is not None:
        options.fourcc = fourcc
    if render_frames_only is not None:
        options.render_frames_only = render_frames_only
    if sample is not None:
        options.sample = sample

    with open(video_results_file) as f:
        data = json.load(f)
    detection_categories = data.get('detection_categories', {})

    videos = [im for im in data['images']
              if im.get('detections') is not None]
    if options.sample is not None and options.sample > 0 and \
            len(videos) > options.sample:
        if options.random_seed is not None:
            import random
            videos = random.Random(options.random_seed).sample(
                videos, options.sample)
        else:
            videos = videos[:options.sample]

    os.makedirs(output_folder, exist_ok=True)
    outputs = []

    for im in videos:

        video_path = os.path.join(input_video_folder, im['file'])
        if not os.path.isfile(video_path):
            print('Warning: video {} not found'.format(video_path))
            continue

        frame_to_detections = defaultdict(list)
        for det in im['detections']:
            if det['conf'] >= options.confidence_threshold and \
                    'frame_number' in det:
                frame_to_detections[det['frame_number']].append(det)

        first_detection_frame = min(frame_to_detections) \
            if frame_to_detections else None
        last_detection_frame = max(frame_to_detections) \
            if frame_to_detections else None

        vidcap = cv2.VideoCapture(video_path)
        if not vidcap.isOpened():
            continue
        if options.rendering_fs != 'auto':
            fs = float(options.rendering_fs)
        else:
            fs = vidcap.get(cv2.CAP_PROP_FPS)
        if not fs or fs <= 0:
            # Some containers report 0 FPS; a zero-FPS VideoWriter
            # silently produces an unplayable file
            fs = 30.0
        width = int(vidcap.get(cv2.CAP_PROP_FRAME_WIDTH))
        height = int(vidcap.get(cv2.CAP_PROP_FRAME_HEIGHT))

        if options.flatten_output:
            out_name = im['file'].replace(
                '/', options.path_separator_replacement).replace(
                '\\', options.path_separator_replacement)
        else:
            out_name = im['file'].replace('\\', '/')
        if options.render_frames_only:
            frame_dir = os.path.join(output_folder,
                                     os.path.splitext(out_name)[0])
            os.makedirs(frame_dir, exist_ok=True)
            writer = None
        else:
            out_path = os.path.join(
                output_folder,
                os.path.splitext(out_name)[0] + '_annotated.mp4')
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            writer = cv2.VideoWriter(
                out_path, cv2.VideoWriter_fourcc(*options.fourcc), fs,
                (width, height))
            outputs.append(out_path)

        frame_number = -1
        while True:
            success, frame = vidcap.read()
            if not success:
                break
            frame_number += 1
            if options.trim_to_detections and \
                    first_detection_frame is not None and \
                    (frame_number < first_detection_frame or
                     frame_number > last_detection_frame):
                continue
            dets = frame_to_detections.get(frame_number, [])
            if dets:
                pil = Image.fromarray(
                    cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                vis_utils.render_detection_bounding_boxes(
                    dets, pil, label_map=detection_categories,
                    confidence_threshold=options.confidence_threshold,
                    classification_label_map=data.get(
                        'classification_categories'),
                    classification_confidence_threshold=options.
                    classification_confidence_threshold)
                frame = cv2.cvtColor(np.asarray(pil),
                                     cv2.COLOR_RGB2BGR)
            if writer is not None:
                writer.write(frame)
            elif dets:
                frame_path = os.path.join(
                    frame_dir, 'frame{:06d}.jpg'.format(frame_number))
                cv2.imwrite(frame_path, frame)
                outputs.append(frame_path)

        vidcap.release()
        if writer is not None:
            writer.release()

    print('Wrote {} annotated outputs to {}'.format(
        len(outputs), output_folder))
    return outputs


def main():
    parser = argparse.ArgumentParser(
        description='Render detections onto videos')
    parser.add_argument('video_results_file')
    parser.add_argument('input_video_folder')
    parser.add_argument('output_folder')
    parser.add_argument('--confidence_threshold', type=float, default=0.2)
    parser.add_argument('--frames_only', action='store_true')
    parser.add_argument('--sample', type=int, default=-1)
    parser.add_argument('--rendering_fs', default='auto',
                        help="output frame rate (float), or 'auto' for "
                             "each video's native rate")
    parser.add_argument('--fourcc', default='mp4v')
    parser.add_argument('--trim_to_detections', action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    options = VideoVisualizationOptions()
    options.confidence_threshold = args.confidence_threshold
    options.render_frames_only = args.frames_only
    options.sample = args.sample
    options.rendering_fs = args.rendering_fs
    options.fourcc = args.fourcc
    options.trim_to_detections = args.trim_to_detections
    visualize_video_output(
        args.video_results_file, args.input_video_folder,
        args.output_folder, options=options)


if __name__ == '__main__':
    main()
