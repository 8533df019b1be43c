"""
Classical-CV change detection for pre-filtering camera-trap images:
frame-differencing / background-subtraction over the time-sorted images of
each camera folder, flagging images with motion.

Behavioral contract follows the reference
(megadetector/detection/change_detection.py:33-711): methods frame_diff /
MOG2 / KNN, global or Otsu thresholding, per-camera-folder processing,
CSV output of per-image motion scores. This stays host-side (cv2); it is
a cheap pre-filter, not a TPU workload.

The port's own copy of megadetector_tpu/detection/change_detection.py:
the same public names, signatures, defaults and output bytes; its
progress bars are plain loops.
"""

import argparse
import csv
import os
import sys

from collections import defaultdict

from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils.path_utils import find_images

try:
    import cv2
    import numpy as np
except ImportError:  # pragma: no cover
    cv2 = None


class ChangeDetectionMethod:
    FRAME_DIFF = 'frame_diff'
    MOG2 = 'mog2'
    KNN = 'knn'
    MOTION_HISTORY = 'motion_history'


class ThresholdMethod:
    GLOBAL = 'global'
    OTSU = 'otsu'
    ADAPTIVE = 'adaptive'


#: Reference names for the two enums
#: (reference: change_detection.py:33-51)
DetectionMethod = ChangeDetectionMethod
ThresholdType = ThresholdMethod


def create_background_subtractor(options=None):
    """
    Create the background subtractor matching options.method
    (reference: change_detection.py:185-215); returns None for methods
    that don't use one (frame differencing, motion history).
    """

    assert cv2 is not None, 'OpenCV is required for change detection'
    if options is None:
        options = ChangeDetectionOptions()
    if options.method == ChangeDetectionMethod.MOG2:
        return cv2.createBackgroundSubtractorMOG2(detectShadows=False)
    if options.method == ChangeDetectionMethod.KNN:
        return cv2.createBackgroundSubtractorKNN(detectShadows=False)
    return None


class ChangeDetectionOptions:
    """Options controlling process_folders()."""

    def __init__(self):
        self.method = ChangeDetectionMethod.FRAME_DIFF
        self.threshold_method = ThresholdMethod.GLOBAL
        # Pixel-difference threshold (global mode)
        self.diff_threshold = 25
        # Fraction of changed pixels above which an image is "motion"
        self.motion_fraction_threshold = 0.002
        # Downscale long side before comparison
        self.comparison_width = 640
        self.blur_kernel = 5
        # Adaptive thresholding (reference :80-81,382-386)
        self.adaptive_block_size = 11
        self.adaptive_c = 2
        # Motion-history mode (reference :107-180)
        self.mhi_buffer_size = 10
        self.mhi_threshold = 25
        self.mhi_duration = 5.0
        self.verbose = False


class MotionHistoryState:
    """
    Motion-history image (MHI) across a frame sequence: per-frame
    binary motion refreshes the MHI to 255 where motion occurred, and
    the whole MHI decays over mhi_duration nominal seconds — so slow,
    persistent movement accumulates while noise fades
    (reference: change_detection.py:107-180, a manual replacement for
    cv2.updateMotionHistory).
    """

    def __init__(self, buffer_size=10, frame_interval=1.0):
        self.buffer_size = buffer_size
        self.frame_interval = frame_interval
        self.frame_buffer = []
        self.mhi = None

    def update(self, frame, options):
        """Add [frame] (grayscale uint8); returns the normalized MHI."""

        if self.mhi is None:
            self.mhi = np.zeros(frame.shape, dtype=np.float32)

        self.frame_buffer.append(frame.copy())
        if len(self.frame_buffer) > self.buffer_size:
            self.frame_buffer.pop(0)
        if len(self.frame_buffer) < 2:
            return np.zeros(frame.shape, dtype=np.uint8)

        prev_frame = self.frame_buffer[-2]
        if prev_frame.shape != frame.shape:
            self.frame_buffer = [frame.copy()]
            self.mhi = np.zeros(frame.shape, dtype=np.float32)
            return np.zeros(frame.shape, dtype=np.uint8)
        frame_diff = cv2.absdiff(prev_frame, frame)
        _, motion_mask = cv2.threshold(frame_diff,
                                       options.mhi_threshold, 1,
                                       cv2.THRESH_BINARY)

        decay = self.frame_interval / options.mhi_duration
        self.mhi = np.maximum(0, self.mhi - decay * 255)
        self.mhi[motion_mask > 0] = 255.0
        return np.uint8(self.mhi)


def _load_gray(path, width):
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        return None
    if img.shape[1] > width:
        scale = width / img.shape[1]
        img = cv2.resize(img, (width, int(round(img.shape[0] * scale))))
    return img


def detect_motion(images, options=None):
    """
    Motion scores for a time-ordered list of image paths from one camera.

    Returns a list of dicts: {'file', 'motion_fraction', 'motion'} (the
    first image of a folder has no baseline and scores 0).
    """

    assert cv2 is not None, 'OpenCV is required for change detection'
    if options is None:
        options = ChangeDetectionOptions()

    results = []
    subtractor = create_background_subtractor(options)
    motion_state = None
    if options.method == ChangeDetectionMethod.MOTION_HISTORY:
        motion_state = MotionHistoryState(
            buffer_size=options.mhi_buffer_size)

    def threshold_diff(diff):
        if options.threshold_method == ThresholdMethod.OTSU:
            _, mask = cv2.threshold(
                diff, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        elif options.threshold_method == ThresholdMethod.ADAPTIVE:
            block = max(3, options.adaptive_block_size | 1)
            mask = cv2.adaptiveThreshold(
                diff, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                cv2.THRESH_BINARY, block, -options.adaptive_c)
        else:
            _, mask = cv2.threshold(
                diff, options.diff_threshold, 255, cv2.THRESH_BINARY)
        return mask

    prev = None
    for path in images:
        img = _load_gray(path, options.comparison_width)
        if img is None:
            results.append({'file': path, 'motion_fraction': -1.0,
                            'motion': False, 'failure': True})
            continue
        if options.blur_kernel > 1:
            img = cv2.GaussianBlur(img, (options.blur_kernel,
                                         options.blur_kernel), 0)

        if motion_state is not None:
            mhi = motion_state.update(img, options)
            fraction = float(np.count_nonzero(mhi)) / mhi.size
            if prev is None:
                fraction = 0.0
        elif subtractor is not None:
            mask = subtractor.apply(img)
            fraction = float(np.count_nonzero(mask)) / mask.size
            # The first frame trains the model; score it 0
            if prev is None:
                fraction = 0.0
        else:
            if prev is None or prev.shape != img.shape:
                fraction = 0.0
            else:
                diff = cv2.absdiff(img, prev)
                mask = threshold_diff(diff)
                fraction = float(np.count_nonzero(mask)) / mask.size

        results.append({
            'file': path,
            'motion_fraction': fraction,
            'motion': fraction >= options.motion_fraction_threshold,
        })
        prev = img

    return results


def create_change_previews(motion_results, output_folder,
                           num_samples=10, random_seed=0,
                           comparison_width=640):
    """
    Side-by-side before/after preview images for motion detections
    (reference: change_detection.py:610-704): each preview shows the
    previous image and the flagged image with the motion fraction
    annotated. Returns the list of preview paths.
    """

    import random

    assert cv2 is not None
    os.makedirs(output_folder, exist_ok=True)

    candidates = []
    for i, r in enumerate(motion_results):
        if r.get('motion') and i > 0 and \
                not motion_results[i - 1].get('failure'):
            candidates.append(i)
    rng = random.Random(random_seed)
    picks = rng.sample(candidates, min(num_samples, len(candidates)))

    preview_paths = []
    for i in sorted(picks):
        prev_img = _load_gray(motion_results[i - 1]['file'],
                              comparison_width)
        cur_img = _load_gray(motion_results[i]['file'],
                             comparison_width)
        if prev_img is None or cur_img is None:
            continue
        if prev_img.shape != cur_img.shape:
            prev_img = cv2.resize(prev_img,
                                  (cur_img.shape[1], cur_img.shape[0]))
        side = np.concatenate([prev_img, cur_img], axis=1)
        side = cv2.cvtColor(side, cv2.COLOR_GRAY2BGR)
        label = 'motion_fraction={:.4f}'.format(
            motion_results[i]['motion_fraction'])
        cv2.putText(side, label, (8, 20), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, (0, 255, 0), 1)
        name = 'preview_{:04d}_{}'.format(
            i, os.path.basename(motion_results[i]['file']))
        out_path = os.path.join(output_folder, name)
        cv2.imwrite(out_path, side)
        preview_paths.append(out_path)

    print('Wrote {} motion previews to {}'.format(
        len(preview_paths), output_folder))
    return preview_paths


def process_camera_folder(folder, image_files, options=None):
    """Run motion detection on one camera folder's images (sorted)."""

    return detect_motion(sorted(image_files), options)


def process_folders(input_folder, output_csv=None, options=None,
                    recursive=True):
    """
    Run motion detection over every camera folder under [input_folder];
    writes a CSV of per-image scores when [output_csv] is given. Returns
    the list of result dicts.
    """

    if options is None:
        options = ChangeDetectionOptions()

    images = find_images(input_folder, recursive=recursive)
    folder_to_images = defaultdict(list)
    for fn in images:
        folder_to_images[os.path.dirname(fn)].append(fn)

    all_results = []
    for folder in sorted(folder_to_images.keys()):
        all_results.extend(process_camera_folder(
            folder, folder_to_images[folder], options))

    if output_csv is not None:
        with open(output_csv, 'w', newline='') as f:
            writer = csv.writer(f)
            writer.writerow(['file', 'motion_fraction', 'motion'])
            for r in all_results:
                writer.writerow([
                    os.path.relpath(r['file'], input_folder),
                    '{:.5f}'.format(r['motion_fraction']),
                    int(r['motion'])])
        print('Wrote motion scores to {}'.format(output_csv))

    n_motion = sum(1 for r in all_results if r['motion'])
    print('Flagged {} of {} images as motion'.format(
        n_motion, len(all_results)))
    return all_results


def main():
    parser = argparse.ArgumentParser(
        description='Classical-CV motion detection pre-filter')
    parser.add_argument('input_folder')
    parser.add_argument('output_csv')
    parser.add_argument('--method', default='frame_diff',
                        choices=['frame_diff', 'mog2', 'knn',
                                 'motion_history'])
    parser.add_argument('--threshold_method', default='global',
                        choices=['global', 'otsu', 'adaptive'])
    parser.add_argument('--preview_folder', default=None,
                        help='write side-by-side motion previews here')
    parser.add_argument('--num_previews', type=int, default=10)
    parser.add_argument('--diff_threshold', type=int, default=25)
    parser.add_argument('--motion_fraction_threshold', type=float,
                        default=0.002)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    options = ChangeDetectionOptions()
    ct_utils.args_to_object(args, options)
    results = process_folders(args.input_folder, args.output_csv,
                              options)
    if args.preview_folder is not None:
        create_change_previews(results, args.preview_folder,
                               num_samples=args.num_previews)


if __name__ == '__main__':
    main()
