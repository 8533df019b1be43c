"""
Render detections from an MD results file onto (a sample of) the images.

Behavioral contract follows the reference
(megadetector/visualization/visualize_detector_output.py:174): renders
boxes above a threshold to an output folder, with optional sampling and
parallel rendering.

The port's own copy of
megadetector_tpu/visualization/visualize_detector_output.py: the same
public names, signatures, defaults and output bytes. No progress bars: the
card's machine is not promised tqdm.
"""

import argparse
import json
import os
import random
import sys

from concurrent.futures import ThreadPoolExecutor

from megadetector_tpu_torch.visualization import \
    visualization_utils as vis_utils


def visualize_detector_output(detector_output_path, out_dir, images_dir,
                              confidence_threshold=0.15, sample=-1,
                              output_image_width=700, random_seed=None,
                              render_detections_only=False,
                              parallelize_rendering=True,
                              n_cores=8):
    """
    Render detections to [out_dir]; returns the list of rendered paths.
    """

    with open(detector_output_path) as f:
        data = json.load(f)

    detection_categories = data.get('detection_categories', {})
    images = [im for im in data['images']
              if im.get('detections') is not None]
    if render_detections_only:
        images = [im for im in images
                  if any(d['conf'] >= confidence_threshold
                         for d in im['detections'])]

    if sample > 0 and len(images) > sample:
        rng = random.Random(random_seed)
        images = rng.sample(images, sample)

    os.makedirs(out_dir, exist_ok=True)

    def _render(job):
        i_image, im = job
        source = os.path.join(images_dir, im['file'])
        target = os.path.join(out_dir, 'anno_{:0>5d}_{}'.format(
            i_image, im['file'].replace('/', '~').replace('\\', '~')))
        try:
            image = vis_utils.load_image(source)
            vis_utils.render_detection_bounding_boxes(
                im['detections'], image,
                label_map=detection_categories,
                confidence_threshold=confidence_threshold)
            if output_image_width is not None and \
                    image.size[0] > output_image_width:
                image = vis_utils.resize_image(
                    image, target_width=output_image_width)
            image.convert('RGB').save(target, quality=85)
            return target
        except Exception as e:
            print('Warning: rendering error for {}: {}'.format(
                im['file'], e))
            return None

    jobs = list(enumerate(images))
    if parallelize_rendering and n_cores > 1:
        with ThreadPoolExecutor(max_workers=n_cores) as pool:
            rendered = list(pool.map(_render, jobs))
    else:
        rendered = [_render(j) for j in jobs]

    rendered = [r for r in rendered if r is not None]
    print('Rendered {} images to {}'.format(len(rendered), out_dir))
    return rendered


def main():
    parser = argparse.ArgumentParser(
        description='Render detections from an MD results file')
    parser.add_argument('detector_output_path')
    parser.add_argument('out_dir')
    parser.add_argument('--images_dir', required=True)
    parser.add_argument('--confidence', type=float, default=0.15)
    parser.add_argument('--sample', type=int, default=-1)
    parser.add_argument('--output_image_width', type=int, default=700)
    parser.add_argument('--detections_only', action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    visualize_detector_output(
        args.detector_output_path, args.out_dir, args.images_dir,
        confidence_threshold=args.confidence, sample=args.sample,
        output_image_width=args.output_image_width,
        render_detections_only=args.detections_only)


if __name__ == '__main__':
    main()
