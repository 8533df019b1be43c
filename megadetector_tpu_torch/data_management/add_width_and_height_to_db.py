"""
Backfill 'width'/'height' on every image in a COCO(-CT) database by
reading the files.

Behavioral contract follows the reference
(megadetector/data_management/add_width_and_height_to_db.py).

The port's own copy of
megadetector_tpu/data_management/add_width_and_height_to_db.py: the same
public names, signatures, defaults and output bytes. No progress bar: the
port does not depend on tqdm. The thread pool's results come back in input
order, as JAX's do.
"""

import argparse
import json
import os
import sys

from concurrent.futures import ThreadPoolExecutor

from megadetector_tpu_torch.utils import ct_utils


def add_width_and_height_to_db(input_file, image_folder,
                               output_file=None, n_workers=8,
                               overwrite_existing=False):
    """
    Fill missing width/height fields; returns the updated dict. Images
    that cannot be read get an 'error' field.
    """

    if isinstance(input_file, str):
        with open(input_file) as f:
            db = json.load(f)
    else:
        db = input_file

    from PIL import Image

    def _one(im):
        if not overwrite_existing and im.get('width') and \
                im.get('height'):
            return
        path = os.path.join(image_folder, im['file_name'])
        try:
            with Image.open(path) as pil_im:
                im['width'], im['height'] = pil_im.size
        except Exception as e:
            im['error'] = str(e)

    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        list(pool.map(_one, db['images']))

    if output_file is not None:
        ct_utils.write_json(output_file, db, force_str=True)
    return db


def main():
    parser = argparse.ArgumentParser(
        description='Backfill width/height in a CCT database')
    parser.add_argument('input_file')
    parser.add_argument('image_folder')
    parser.add_argument('output_file')
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()
    add_width_and_height_to_db(args.input_file, args.image_folder,
                               args.output_file)


if __name__ == '__main__':
    main()
