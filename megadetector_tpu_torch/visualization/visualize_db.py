"""
Render (a sample of) the annotations in a COCO Camera Traps database to
an HTML preview.

Behavioral contract follows the reference
(megadetector/visualization/visualize_db.py:175): sampled images with
ground-truth boxes drawn, class names in titles, written as an HTML
gallery.

The port's own copy of megadetector_tpu/visualization/visualize_db.py:
the same public names, signatures, defaults and output bytes. No progress
bars: the card's machine is not promised tqdm.
"""

import argparse
import os
import random
import sys

from megadetector_tpu_torch.data_management.cct_json_utils import IndexedJsonDb
from megadetector_tpu_torch.utils.write_html_image_list import \
    write_html_image_list
from megadetector_tpu_torch.visualization import \
    visualization_utils as vis_utils


class DbVizOptions:
    """Options controlling visualize_db()."""

    def __init__(self):
        self.num_to_visualize = 200
        self.viz_size = (675, -1)
        self.random_seed = 0
        self.add_search_links = False
        self.include_filename_links = False
        self.box_thickness = 4
        self.box_expansion = 0
        self.classes_to_exclude = None
        self.classes_to_include = None
        self.parallelize_rendering = False


def visualize_db(db_path, output_dir, image_base_dir, options=None):
    """
    Render sampled DB annotations to [output_dir]/index.html. Returns
    (html filename, image dicts rendered).
    """

    if options is None:
        options = DbVizOptions()

    db = IndexedJsonDb(db_path)
    os.makedirs(output_dir, exist_ok=True)
    rendering_dir = os.path.join(output_dir, 'rendered_images')
    os.makedirs(rendering_dir, exist_ok=True)

    images = db.db['images']

    # Optional class filters
    def classes_ok(im):
        class_names = set(db.get_classes_for_image(im))
        if options.classes_to_include is not None:
            if not class_names & set(options.classes_to_include):
                return False
        if options.classes_to_exclude is not None:
            if class_names & set(options.classes_to_exclude):
                return False
        return True

    images = [im for im in images if classes_ok(im)]

    if options.num_to_visualize is not None and \
            len(images) > options.num_to_visualize:
        rng = random.Random(options.random_seed)
        images = rng.sample(images, options.num_to_visualize)

    entries = []
    for i_image, im in enumerate(images):
        source = os.path.join(image_base_dir, im['file_name'])
        target = os.path.join(rendering_dir, '{:0>5d}_{}'.format(
            i_image, im['file_name'].replace('/', '~')))
        annotations = db.get_annotations_for_image(im)
        class_names = db.get_classes_for_image(im)
        try:
            image = vis_utils.load_image(source)
            img_w, img_h = image.size
            for ann in annotations:
                bbox = ann.get('bbox')
                if bbox is None:
                    continue
                # COCO bbox is absolute [x, y, w, h]
                x, y, w, h = bbox
                label = db.cat_id_to_name.get(ann['category_id'], '')
                vis_utils.draw_bounding_box_on_image(
                    image, y / img_h, x / img_w, (y + h) / img_h,
                    (x + w) / img_w, clss=ann['category_id'],
                    thickness=options.box_thickness,
                    expansion=options.box_expansion,
                    display_str_list=[label])
            if options.viz_size[0] > 0 and image.size[0] > \
                    options.viz_size[0]:
                image = vis_utils.resize_image(
                    image, target_width=options.viz_size[0])
            image.convert('RGB').save(target, quality=85)
        except Exception as e:
            print('Warning: rendering error for {}: {}'.format(
                im['file_name'], e))
            continue
        entries.append({
            'filename': os.path.relpath(target, output_dir),
            'title': '{} ({})'.format(im['file_name'],
                                      ', '.join(class_names)),
        })

    html_file = os.path.join(output_dir, 'index.html')
    write_html_image_list(html_file, entries,
                          {'headerHtml': '<h1>Database preview</h1>'})
    print('Wrote database preview to {}'.format(html_file))
    return html_file, images


def main():
    parser = argparse.ArgumentParser(
        description='Render a sample of a CCT database to HTML')
    parser.add_argument('db_path')
    parser.add_argument('output_dir')
    parser.add_argument('image_base_dir')
    parser.add_argument('--num_to_visualize', type=int, default=200)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    options = DbVizOptions()
    options.num_to_visualize = args.num_to_visualize
    visualize_db(args.db_path, args.output_dir, args.image_base_dir,
                 options)


if __name__ == '__main__':
    main()
