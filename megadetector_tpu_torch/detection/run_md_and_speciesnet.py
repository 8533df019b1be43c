"""
The port's copy of megadetector_tpu/detection/run_md_and_speciesnet.py,
on the port's two-stage driver (run_md_and_classifier.py); the CLI adds
--device.

Compatibility surface for the reference's run_md_and_speciesnet module
(reference: megadetector/detection/run_md_and_speciesnet.py). The
two-stage detect -> crop -> classify pipeline lives in
run_md_and_classifier.py (same crop-producer/bounded-queue design, plus
video-crop classification and the ensemble stage); this module maps the
reference's option names onto it so reference-style code runs unchanged:

    options = RunMDSpeciesNetOptions()
    options.source = '/data/images'
    options.output_file = 'results.json'
    run_md_and_speciesnet(options)
"""

import argparse
import sys

from megadetector_tpu_torch.detection.run_md_and_classifier import (
    MDAndClassifierOptions, run_md_and_classifier)


class RunMDSpeciesNetOptions(MDAndClassifierOptions):
    """
    Options controlling run_md_and_speciesnet() (reference:
    run_md_and_speciesnet.py:106-194). Extends MDAndClassifierOptions
    with the reference's field names; both naming families work.
    """

    def __init__(self):
        super().__init__()
        #: Folder containing images and/or videos to process
        #: (reference name for input_folder)
        self.source = None
        #: What to do if the output file exists
        #: ('overwrite', 'error', 'skip')
        self.overwrite_handling = 'overwrite'
        #: SpeciesNet classifier model identifier (reference name for
        #: classifier_model)
        self.classification_model = None
        #: Reference names for the two detection thresholds
        self.detection_confidence_threshold_for_classification = None
        self.detection_confidence_threshold_for_output = None
        #: Disable taxonomic rollup
        self.norollup = False
        #: Target confidence threshold for taxonomic rollup
        self.rollup_target_confidence = 0.65
        #: Path to an existing MD output file (skips detection)
        self.detections_file = None
        #: Ignore videos, only process images
        self.ignore_videos = False


class CropMetadata:
    """
    Metadata for one crop extracted from an image detection (reference:
    run_md_and_speciesnet.py:199-223).
    """

    def __init__(self, image_file, detection_index, bbox,
                 original_width, original_height):
        self.image_file = image_file
        #: Index of this detection within its image's detections
        self.detection_index = detection_index
        #: Normalized [x_min, y_min, width, height]
        self.bbox = bbox
        self.original_width = original_width
        self.original_height = original_height


class CropBatch:
    """
    A batch of crops plus their metadata, bound for the classifier
    (reference: run_md_and_speciesnet.py:226-250).
    """

    def __init__(self):
        #: Preprocessed crop arrays
        self.crops = []
        #: CropMetadata objects, parallel to crops
        self.metadata = []

    def add_crop(self, crop_data, metadata):
        self.crops.append(crop_data)
        self.metadata.append(metadata)

    def __len__(self):
        return len(self.crops)


def run_md_and_speciesnet(options):
    """
    Run the two-stage MegaDetector + classifier pipeline (reference:
    run_md_and_speciesnet.py). Accepts a RunMDSpeciesNetOptions (or an
    MDAndClassifierOptions); returns the results dict.
    """

    import os

    # Map reference-style fields onto the underlying options
    if getattr(options, 'source', None) is not None:
        options.input_folder = options.source
    if getattr(options, 'classification_model', None) is not None:
        options.classifier_model = options.classification_model
    if getattr(options,
               'detection_confidence_threshold_for_output',
               None) is not None:
        options.detection_confidence_threshold = \
            options.detection_confidence_threshold_for_output
    if getattr(options, 'rollup_target_confidence', None) is not None:
        options.rollup_confidence_threshold = \
            options.rollup_target_confidence
    if getattr(options, 'norollup', False):
        options.apply_ensemble = False
    if getattr(options, 'ignore_videos', False):
        options.include_videos = False

    overwrite_handling = getattr(options, 'overwrite_handling',
                                 'overwrite')
    if options.output_file is not None and \
            os.path.isfile(options.output_file):
        if overwrite_handling == 'error':
            raise ValueError('Output file {} exists'.format(
                options.output_file))
        elif overwrite_handling == 'skip':
            print('Output file {} exists, skipping'.format(
                options.output_file))
            import json
            with open(options.output_file) as f:
                return json.load(f)
        else:
            assert overwrite_handling == 'overwrite', \
                'Unrecognized overwrite_handling {}'.format(
                    overwrite_handling)

    return run_md_and_classifier(options)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Run MegaDetector and a species classifier on a '
                    'folder of images/videos')
    parser.add_argument('source')
    parser.add_argument('output_file')
    parser.add_argument('--detector_model', default='MDV5A')
    parser.add_argument('--classification_model', default=None)
    parser.add_argument('--detector_batch_size', type=int, default=8)
    parser.add_argument('--classifier_batch_size', type=int, default=64)
    parser.add_argument('--country', default=None)
    parser.add_argument('--admin1_region', default=None)
    parser.add_argument('--norollup', action='store_true')
    parser.add_argument('--ignore_videos', action='store_true')
    parser.add_argument('--overwrite_handling', default='overwrite',
                        choices=['overwrite', 'error', 'skip'])
    parser.add_argument('--device', default=None,
                        help="'cuda' (default), 'cuda:N' or 'cpu'")

    if argv is None:
        argv = sys.argv[1:]
    if len(argv) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args(argv)
    options = RunMDSpeciesNetOptions()
    options.source = args.source
    options.output_file = args.output_file
    options.detector_model = args.detector_model
    options.classification_model = args.classification_model
    options.detector_batch_size = args.detector_batch_size
    options.classifier_batch_size = args.classifier_batch_size
    options.country = args.country
    options.admin1_region = args.admin1_region
    options.norollup = args.norollup
    options.ignore_videos = args.ignore_videos
    options.overwrite_handling = args.overwrite_handling
    options.device = args.device
    run_md_and_speciesnet(options)


if __name__ == '__main__':
    main()
