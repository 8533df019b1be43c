"""
CLI driver for the repeat-detection-elimination candidate finder.

Same entry point and argument names as the reference
(megadetector/postprocessing/repeat_detection_elimination/
find_repeat_detections.py:26-120) so migrating workflows run
unchanged; the work happens in repeat_detections_core. Typical flow:
run this, manually DELETE renderings of real animals from the
filtering folder, then run remove_repeat_detections.

The port's own copy of
megadetector_tpu/postprocessing/repeat_detection_elimination/find_repeat_detections.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import sys

from megadetector_tpu_torch.postprocessing \
    .repeat_detection_elimination import repeat_detections_core


def main():
    parser = argparse.ArgumentParser(
        description='Find candidate repeat false-positive detections '
                    'for manual review')
    parser.add_argument('inputFile',
                        help='MD results .json file to process')
    parser.add_argument('--outputFile', default=None,
                        help='filtered MD results .json (omit to only '
                             'build the review folder)')
    parser.add_argument('--imageBase', default='',
                        help='root folder the result paths are '
                             'relative to')
    parser.add_argument('--outputBase', default='',
                        help='folder for the human-review renderings')
    parser.add_argument('--confidenceMin', type=float, default=None)
    parser.add_argument('--confidenceMax', type=float, default=None)
    parser.add_argument('--iouThreshold', type=float, default=None,
                        help='boxes above this IoU count as the same '
                             'detection')
    parser.add_argument('--occurrenceThreshold', type=int, default=None,
                        help='occurrences before a detection becomes '
                             'suspicious')
    parser.add_argument('--minSuspiciousDetectionSize', type=float,
                        default=None)
    parser.add_argument('--maxSuspiciousDetectionSize', type=float,
                        default=None)
    parser.add_argument('--maxImagesPerFolder', type=int, default=None)
    parser.add_argument('--excludeClasses', nargs='+', type=int,
                        default=None)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()

    options = repeat_detections_core.RepeatDetectionOptions()
    options.imageBase = args.imageBase
    options.outputBase = args.outputBase
    for name in ('confidenceMin', 'confidenceMax', 'iouThreshold',
                 'occurrenceThreshold', 'minSuspiciousDetectionSize',
                 'maxSuspiciousDetectionSize', 'maxImagesPerFolder',
                 'excludeClasses'):
        value = getattr(args, name)
        if value is not None:
            setattr(options, name, value)

    results = repeat_detections_core.find_repeat_detections(
        args.inputFile, args.outputFile, options)
    n_groups = sum(len(v) for v in
                   (results.suspicious_detections or {}).values())
    print('Found {} suspicious detection groups'.format(n_groups))


if __name__ == '__main__':
    main()
