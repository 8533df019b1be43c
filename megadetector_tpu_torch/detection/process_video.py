"""
Video inference driver for the port (counterpart of
megadetector_tpu/detection/process_video.py): sampled frames -> batches
for the detector -> one MD-format record per video.

frame_sample and time_sample are mutually exclusive (time is passed to the
frame runner as a negative every_n_frames); each video's frames merge into
one record with 'frame_rate', 'frames_processed' and a 'frame_number' on
every detection, and the written file is validated. Frames go to the
detector in batches of frame_batch_size that never span two videos.
A video that cannot be decoded becomes a failure record; a kernel or CUDA
fault propagates (detection/video_utils.py).

    python -m megadetector_tpu_torch.detection.process_video model.npz \\
        videos --output_json_file out.json --frame_sample 4 [--device cpu]
"""

import argparse
import os
import sys

from megadetector_tpu_torch.detection import run_detector_batch
from megadetector_tpu_torch.detection import video_utils
from megadetector_tpu_torch.detection.run_detector import (
    DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD,
    DEFAULT_RENDERING_CONFIDENCE_THRESHOLD,
    load_detector,
)
from megadetector_tpu_torch.detection.video_utils import (
    _filename_to_frame_number,
)
from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.postprocessing.validate_batch_results import (
    ValidateBatchResultsOptions, validate_batch_results)


class ProcessVideoOptions:
    """
    Options controlling process_videos(). [device] is 'cuda', 'cuda:N',
    'cpu' or None (CUDA; raises without a card). [model_file] may also be
    a detector object (anything with generate_detections_one_batch).
    """

    def __init__(self):
        self.model_file = 'MDV5A'
        self.input_video_file = None
        self.output_json_file = None
        self.output_video_file = None
        self.render_output_video = False
        self.keep_rendered_frames = False
        self.keep_extracted_frames = False
        self.force_extracted_frame_folder_deletion = False
        self.force_rendered_frame_folder_deletion = False
        self.reuse_results_if_available = False
        self.recursive = True
        self.verbose = False
        self.fourcc = None
        self.rendering_confidence_threshold = None
        self.json_confidence_threshold = \
            DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD
        # Sample every Nth frame; mutually exclusive with time_sample
        self.frame_sample = None
        # Sample every N seconds; mutually exclusive with frame_sample
        self.time_sample = None
        self.n_cores = 1
        self.frame_batch_size = 8
        self.image_size = None
        self.augment = False
        self.exit_on_empty_video = False
        self.detector_options = None
        self.frame_rendering_folder = None
        self.frame_extraction_folder = None
        self.device = None


def _validate_video_options(options):
    if options.time_sample is not None:
        assert options.frame_sample is None, \
            'frame_sample and time_sample are mutually exclusive'
        assert options.time_sample > 0, \
            'time_sample must be positive'
    if options.frame_sample is not None:
        assert options.frame_sample > 0, \
            'frame_sample must be positive'
    return options


def process_videos(options):
    """
    Run a detector over a video file or folder of videos, writing one
    MD-format record per video to options.output_json_file (default: the
    input's name + '.json'). Returns the output dict.
    """

    _validate_video_options(options)

    if options.output_json_file is None:
        video_file = options.input_video_file.replace('\\', '/')
        if video_file.endswith('/'):
            video_file = video_file[:-1]
        options.output_json_file = video_file + '.json'
        print('Output file not specified, defaulting to {}'.format(
            options.output_json_file))

    assert options.output_json_file.endswith('.json'), \
        'Illegal output file {}'.format(options.output_json_file)

    if options.time_sample is not None:
        every_n_frames_param = -1 * options.time_sample
    else:
        every_n_frames_param = options.frame_sample

    if hasattr(options.model_file, 'generate_detections_one_batch'):
        detector = options.model_file
    else:
        detector = load_detector(options.model_file,
                                 detector_options=options.detector_options,
                                 device=options.device)

    def batch_callback(images_np, image_ids):
        return detector.generate_detections_one_batch(
            images_np, image_ids,
            detection_threshold=options.json_confidence_threshold,
            augment=options.augment,
            image_size=options.image_size,
            verbose=options.verbose)

    if os.path.isfile(options.input_video_file):
        video_folder = os.path.dirname(options.input_video_file)
        video_bn = os.path.basename(options.input_video_file)
        md_results = video_utils.run_callback_on_frames_for_folder(
            input_video_folder=video_folder,
            frame_callback=None,
            batch_callback=batch_callback,
            batch_size=options.frame_batch_size,
            every_n_frames=every_n_frames_param,
            verbose=options.verbose,
            files_to_process_relative=[video_bn],
            error_on_empty_video=options.exit_on_empty_video)
    else:
        assert os.path.isdir(options.input_video_file), \
            '{} is neither a file nor a folder'.format(
                options.input_video_file)
        video_folder = options.input_video_file
        md_results = video_utils.run_callback_on_frames_for_folder(
            input_video_folder=options.input_video_file,
            frame_callback=None,
            batch_callback=batch_callback,
            batch_size=options.frame_batch_size,
            every_n_frames=every_n_frames_param,
            verbose=options.verbose,
            recursive=options.recursive,
            error_on_empty_video=options.exit_on_empty_video)

    print('Finished running detector on videos')

    video_results = md_results['results']
    video_filenames = md_results['video_filenames']
    video_frame_rates = md_results['frame_rates']

    assert len(video_results) == len(video_filenames)
    assert len(video_results) == len(video_frame_rates)

    video_list_md_format = []

    for i_video, results_this_video in enumerate(video_results):

        video_fn = video_filenames[i_video]
        im = {'file': video_fn,
              'frame_rate': video_frame_rates[i_video],
              'frames_processed': []}

        if isinstance(results_this_video, dict):
            assert 'failure' in results_this_video
            im['failure'] = results_this_video['failure']
            im['detections'] = None
        else:
            im['detections'] = []
            for results_one_frame in results_this_video:
                assert results_one_frame['file'].startswith(video_fn)
                frame_number = _filename_to_frame_number(
                    results_one_frame['file'])
                assert frame_number not in im['frames_processed'], \
                    'Received the same frame twice for video {}'.format(
                        im['file'])
                im['frames_processed'].append(frame_number)
                frame_detections = results_one_frame.get('detections')
                if frame_detections is None:
                    # Per-frame inference failure: mark the whole video
                    im['failure'] = results_one_frame.get(
                        'failure', 'frame failure')
                    im['detections'] = None
                    break
                for det in frame_detections:
                    det['frame_number'] = frame_number
                im['detections'].extend(frame_detections)

        im['frames_processed'] = sorted(im['frames_processed'])
        video_list_md_format.append(im)

    output = run_detector_batch.write_results_to_file(
        video_list_md_format,
        options.output_json_file,
        relative_path_base=None,
        detector_file=options.model_file if isinstance(
            options.model_file, str) else None)

    validation_options = ValidateBatchResultsOptions()
    validation_options.raise_errors = True
    validation_options.check_image_existence = False
    validation_options.return_data = False
    validate_batch_results(options.output_json_file,
                           options=validation_options)

    return output


def process_video(options):
    """Single-video alias for process_videos()."""

    return process_videos(options)


def options_to_command(options):
    """ProcessVideoOptions -> the equivalent CLI string (to print runnable
    commands)."""

    cmd = 'python -m megadetector_tpu_torch.detection.process_video'
    cmd += ' "' + str(options.model_file) + '"'
    cmd += ' "' + str(options.input_video_file) + '"'
    # The CLI default for --recursive is True (BooleanOptionalAction), so
    # False must be printed or the command would recurse
    if options.recursive:
        cmd += ' --recursive'
    else:
        cmd += ' --no-recursive'
    if options.output_json_file is not None:
        cmd += ' --output_json_file "' + options.output_json_file + '"'
    if options.json_confidence_threshold is not None:
        cmd += ' --json_confidence_threshold ' + \
            str(options.json_confidence_threshold)
    if options.rendering_confidence_threshold is not None:
        cmd += ' --rendering_confidence_threshold ' + \
            str(options.rendering_confidence_threshold)
    if options.frame_sample is not None:
        cmd += ' --frame_sample ' + str(options.frame_sample)
    if options.time_sample is not None:
        cmd += ' --time_sample ' + str(options.time_sample)
    if options.frame_batch_size is not None and \
            options.frame_batch_size != 8:
        cmd += ' --frame_batch_size ' + str(options.frame_batch_size)
    if options.image_size is not None:
        cmd += ' --image_size ' + str(options.image_size)
    if options.verbose:
        cmd += ' --verbose'
    if options.detector_options:
        cmd += ' --detector_options {}'.format(
            ct_utils.dict_to_kvp_list(options.detector_options))
    if options.device is not None:
        cmd += ' --device ' + str(options.device)
    return cmd


def main(argv=None):

    parser = argparse.ArgumentParser(
        description='Run MegaDetector (PyTorch port) on a video or folder '
                    'of videos')
    parser.add_argument('model_file',
                        help='model file or known model name')
    parser.add_argument('input_video_file',
                        help='video file or folder to process')
    parser.add_argument('--output_json_file', default=None)
    parser.add_argument('--recursive',
                        action=argparse.BooleanOptionalAction,
                        default=True,
                        help='recurse into subfolders (default on; '
                             'disable with --no-recursive)')
    parser.add_argument('--frame_sample', type=int, default=None,
                        help='process every Nth frame')
    parser.add_argument('--time_sample', type=float, default=None,
                        help='process one frame every N seconds')
    parser.add_argument('--json_confidence_threshold', type=float,
                        default=DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD)
    parser.add_argument('--rendering_confidence_threshold', type=float,
                        default=DEFAULT_RENDERING_CONFIDENCE_THRESHOLD)
    parser.add_argument('--frame_batch_size', type=int, default=8)
    parser.add_argument('--image_size', type=int, default=None)
    parser.add_argument('--verbose', action='store_true')
    parser.add_argument('--detector_options', nargs='*', default=None)
    parser.add_argument('--device', default=None,
                        help="'cuda' (default), 'cuda:N' or 'cpu'")

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args(argv)

    options = ProcessVideoOptions()
    ct_utils.args_to_object(args, options)
    options.detector_options = ct_utils.parse_kvp_list(
        args.detector_options)

    return process_videos(options)


if __name__ == '__main__':
    main()
