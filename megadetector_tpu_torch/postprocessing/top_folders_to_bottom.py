"""
Move the top-level folder of every file to the bottom of its path
(reference: megadetector/postprocessing/top_folders_to_bottom.py):
'animal/camera01/image01.jpg' -> 'camera01/animal/image01.jpg'. Used to
re-organize separate_detections_into_folders output by camera.

The port's own copy of
megadetector_tpu/postprocessing/top_folders_to_bottom.py: the same public
names, signatures, defaults and output bytes.
"""

import argparse
import os
import shutil
import sys


class TopFoldersToBottomOptions:

    def __init__(self, input_folder=None, output_folder=None):
        self.input_folder = input_folder
        self.output_folder = output_folder
        # 'copy' or 'move'
        self.copy_or_move = 'copy'
        # Files directly inside input_folder (no subfolder) are skipped
        # unless this is set, in which case they're copied unchanged
        self.include_root_files = False
        self.n_threads = 1


def _remapped_path(relative_path):
    parts = relative_path.replace('\\', '/').split('/')
    if len(parts) < 2:
        return None
    top = parts[0]
    rest = parts[1:-1]
    return '/'.join(rest + [top, parts[-1]])


def top_folders_to_bottom(options):
    """
    Re-organize options.input_folder into options.output_folder with
    top-level folders moved to the bottom. Returns {input relative
    path: output relative path}.
    """

    assert os.path.isdir(options.input_folder)
    assert options.copy_or_move in ('copy', 'move')
    assert os.path.abspath(options.input_folder) != \
        os.path.abspath(options.output_folder)
    os.makedirs(options.output_folder, exist_ok=True)

    mapping = {}
    for root, _, files in os.walk(options.input_folder):
        for fn in files:
            rel = os.path.relpath(os.path.join(root, fn),
                                  options.input_folder)
            rel = rel.replace('\\', '/')
            remapped = _remapped_path(rel)
            if remapped is None:
                if not options.include_root_files:
                    continue
                remapped = rel
            mapping[rel] = remapped

    for rel, remapped in mapping.items():
        src = os.path.join(options.input_folder, rel)
        dst = os.path.join(options.output_folder, remapped)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if options.copy_or_move == 'copy':
            shutil.copyfile(src, dst)
        else:
            shutil.move(src, dst)

    print('{} {} files'.format(
        'Copied' if options.copy_or_move == 'copy' else 'Moved',
        len(mapping)))
    return mapping


def main():
    parser = argparse.ArgumentParser(
        description='Move top-level folders to the bottom of each path')
    parser.add_argument('input_folder')
    parser.add_argument('output_folder')
    parser.add_argument('--move', action='store_true',
                        help='move instead of copy')
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()
    options = TopFoldersToBottomOptions(args.input_folder,
                                        args.output_folder)
    options.copy_or_move = 'move' if args.move else 'copy'
    top_folders_to_bottom(options)


if __name__ == '__main__':
    main()
