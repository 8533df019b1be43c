"""
Video batch workflow for the port (counterpart of
megadetector_tpu/workflows/manage_video_batch.py): the frames-on-disk
variant of video processing. It extracts the sampled frames of every video
to a frame folder, runs the batch driver on the frames, then folds the
frame results back into one record per video.

The in-memory path is detection/process_video.py; this workflow is for
jobs that want the frames on disk for review or reprocessing.

    python -m megadetector_tpu_torch.workflows.manage_video_batch videos \\
        frames out.json --model_file model.npz [--device cpu]
"""

import os

from megadetector_tpu_torch.detection import run_detector_batch
from megadetector_tpu_torch.detection import video_utils
from megadetector_tpu_torch.utils import path_utils


class VideoBatchOptions:
    """
    Options controlling process_video_folder_via_frames(). [device] is
    'cuda', 'cuda:N', 'cpu' or None (CUDA; raises without a card).
    """

    def __init__(self):
        self.model_file = 'MDV5A'
        self.input_video_folder = None
        self.frame_folder = None
        self.output_json_file = None
        self.every_n_frames = 10
        self.quality = 90
        self.max_width = None
        self.batch_size = 8
        self.image_size = None
        self.detector_options = None
        self.n_extraction_threads = 1
        self.keep_frames = False
        self.device = None


def process_video_folder_via_frames(options):
    """
    Extract frames -> batch inference -> video-level results. Returns the
    video-level results dict.
    """

    assert options.input_video_folder is not None
    assert options.frame_folder is not None
    if options.output_json_file is None:
        options.output_json_file = \
            options.input_video_folder.rstrip('/\\') + '.json'

    # --- Stage 1: frames to disk
    frame_filenames_by_video, fs_by_video, video_filenames = \
        video_utils.video_folder_to_frames(
            options.input_video_folder, options.frame_folder,
            every_n_frames=options.every_n_frames,
            quality=options.quality, max_width=options.max_width,
            n_threads=options.n_extraction_threads,
            allow_empty_videos=True)

    # --- Stage 2: standard image pipeline over the frames
    frame_files = path_utils.find_images(options.frame_folder,
                                         recursive=True)
    results = run_detector_batch.load_and_run_detector_batch(
        options.model_file, frame_files,
        batch_size=options.batch_size,
        image_size=options.image_size,
        detector_options=options.detector_options,
        quiet=True, device=options.device)

    frame_results_file = options.output_json_file + '.frames.json'
    run_detector_batch.write_results_to_file(
        results, frame_results_file,
        relative_path_base=options.frame_folder,
        detector_file=options.model_file if isinstance(
            options.model_file, str) else None)

    # --- Stage 3: frame-level -> video-level
    video_fn_to_fs = {}
    for video_fn_abs, fs in zip(video_filenames, fs_by_video):
        rel = os.path.relpath(video_fn_abs,
                              options.input_video_folder).replace(
                                  '\\', '/')
        video_fn_to_fs[rel] = fs

    # Keep per-frame detections (rather than one canonical detection
    # per category) so downstream visualization can render every frame
    frame_to_video_options = video_utils.FrameToVideoOptions()
    frame_to_video_options.include_all_processed_frames = True
    data = video_utils.frame_results_to_video_results(
        frame_results_file, options.output_json_file,
        options=frame_to_video_options,
        video_filename_to_frame_rate=video_fn_to_fs)

    if not options.keep_frames:
        import shutil
        shutil.rmtree(options.frame_folder, ignore_errors=True)
        os.remove(frame_results_file)

    print('Wrote video-level results to {}'.format(
        options.output_json_file))
    return data


def main(argv=None):
    import argparse
    import sys
    parser = argparse.ArgumentParser(
        description='Process a video folder via frame extraction')
    parser.add_argument('input_video_folder')
    parser.add_argument('frame_folder')
    parser.add_argument('output_json_file')
    parser.add_argument('--model_file', default='MDV5A')
    parser.add_argument('--every_n_frames', type=int, default=10)
    parser.add_argument('--keep_frames', action='store_true')
    parser.add_argument('--device', default=None,
                        help="'cuda' (default), 'cuda:N' or 'cpu'")

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args(argv)
    options = VideoBatchOptions()
    options.input_video_folder = args.input_video_folder
    options.frame_folder = args.frame_folder
    options.output_json_file = args.output_json_file
    options.model_file = args.model_file
    options.every_n_frames = args.every_n_frames
    options.keep_frames = args.keep_frames
    options.device = args.device
    return process_video_folder_via_frames(options)


if __name__ == '__main__':
    main()
