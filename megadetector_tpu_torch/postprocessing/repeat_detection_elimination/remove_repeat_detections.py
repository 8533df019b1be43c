"""
Apply a human-reviewed repeat-detection filtering folder to a results
file: repeats whose renderings the reviewer left in place get negative
confidences.

Behavioral contract follows the reference
(megadetector/postprocessing/repeat_detection_elimination/
remove_repeat_detections.py:26-49).

The port's own copy of
megadetector_tpu/postprocessing/repeat_detection_elimination/remove_repeat_detections.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import os
import sys

from megadetector_tpu_torch.postprocessing \
    .repeat_detection_elimination import repeat_detections_core


def remove_repeat_detections(input_file, output_file, filtering_dir,
                             options=None):
    """
    Args:
        input_file: original MD results .json
        output_file: destination for the filtered results
        filtering_dir: the filtering folder written by
            find_repeat_detections (after human review), or the
            detectionIndex.json inside it
    """

    assert os.path.isfile(input_file), \
        "Can't find file {}".format(input_file)

    if os.path.isdir(filtering_dir):
        filter_file = os.path.join(
            filtering_dir,
            repeat_detections_core.DETECTION_INDEX_FILE_NAME)
    else:
        filter_file = filtering_dir
    assert os.path.isfile(filter_file), \
        "Can't find detection index file {}".format(filter_file)

    if options is None:
        options = repeat_detections_core.RepeatDetectionOptions()
    options.filterFileToLoad = filter_file
    options.bWriteFilteringFolder = False

    return repeat_detections_core.find_repeat_detections(
        input_file, output_file, options)


def main():
    parser = argparse.ArgumentParser(
        description='Apply a reviewed repeat-detection filter to a '
                    'results file')
    parser.add_argument('input_file')
    parser.add_argument('output_file')
    parser.add_argument('filtering_dir')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    remove_repeat_detections(args.input_file, args.output_file,
                             args.filtering_dir)


if __name__ == '__main__':
    main()
