"""
Compose a review image: one primary image next to a grid of crops taken
from other images.

Used by repeat-detection review to answer "is this box the same static
object across many images?" at a glance (reference:
megadetector/visualization/render_images_with_thumbnails.py:49-191).

The grid shape is chosen to minimize the difference between the grid's
aspect ratio and the aspect the crops would naturally fill, then crops
are letter-fitted into equal cells.

The port's own copy of
megadetector_tpu/visualization/render_images_with_thumbnails.py: the same
public names, signatures, defaults and output bytes.
"""

import math
import os

from megadetector_tpu_torch.visualization import \
    visualization_utils as vis_utils


def crop_image_with_normalized_coordinates(image, bounding_box):
    """
    Crop [image] to the normalized (x, y, w, h) box (MD convention:
    origin upper-left, all values in [0, 1]).
    """

    im_w, im_h = image.size
    x, y, w, h = bounding_box
    return image.crop((x * im_w, y * im_h, (x + w) * im_w, (y + h) * im_h))


def _best_grid(n_crops, crop_aspect, grid_aspect):
    """Rows/cols whose combined aspect best matches [grid_aspect]."""

    best = (1, n_crops, None)
    for rows in range(1, n_crops + 1):
        cols = math.ceil(n_crops / rows)
        err = abs(grid_aspect - (cols / rows) * crop_aspect)
        if best[2] is None or err < best[2]:
            best = (rows, cols, err)
    return best[0], best[1]


def render_images_with_thumbnails(primary_image_filename,
                                  primary_image_width,
                                  secondary_image_filename_list,
                                  secondary_image_bounding_box_list,
                                  cropped_grid_width,
                                  output_image_filename,
                                  primary_image_location='right'):
    """
    Write an image that shows the primary image beside a grid of crops.

    Args:
        primary_image_filename: image shown whole (at
            [primary_image_width] px wide; None = original width)
        secondary_image_filename_list: images to crop from
        secondary_image_bounding_box_list: one normalized (x, y, w, h)
            per secondary image
        cropped_grid_width: width in px reserved for the crop grid
        output_image_filename: where to write the composite
        primary_image_location: 'left' or 'right'

    Returns:
        the output filename
    """

    assert len(secondary_image_filename_list) == \
        len(secondary_image_bounding_box_list), \
        'One bounding box is required per secondary image'
    assert primary_image_location in ('left', 'right')
    assert len(secondary_image_filename_list) > 0

    primary = vis_utils.load_image(primary_image_filename)
    if primary_image_width is not None:
        primary = vis_utils.resize_image(primary, primary_image_width,
                                         target_height=-1)

    grid_w = cropped_grid_width
    grid_h = primary.size[1]

    # Grid shape from the first crop's aspect (crops from repeat
    # detections are near-identical boxes, so one sample suffices)
    sample_w = secondary_image_bounding_box_list[0][2]
    sample_h = secondary_image_bounding_box_list[0][3]
    n_crops = len(secondary_image_filename_list)
    rows, cols = _best_grid(
        n_crops, (sample_w / max(sample_h, 1e-9)), grid_w / grid_h)

    cell_w = grid_w // cols
    cell_h = grid_h // rows

    crops = []
    for filename, box in zip(secondary_image_filename_list,
                             secondary_image_bounding_box_list):
        im = vis_utils.load_image(filename)
        crop = crop_image_with_normalized_coordinates(im, box)
        scale = min(cell_w / max(crop.size[0], 1),
                    cell_h / max(crop.size[1], 1))
        crop = crop.resize((max(1, int(crop.size[0] * scale)),
                            max(1, int(crop.size[1] * scale))))
        crops.append(crop)

    from PIL import Image

    out = Image.new('RGB', (primary.size[0] + grid_w, primary.size[1]))
    primary_x = grid_w if primary_image_location == 'right' else 0
    out.paste(primary, (primary_x, 0))

    grid_x0 = primary.size[0] if primary_image_location == 'left' else 0
    for i, crop in enumerate(crops):
        row, col = divmod(i, cols)
        out.paste(crop, (grid_x0 + col * cell_w, row * cell_h))

    parent = os.path.dirname(output_image_filename)
    if parent:
        os.makedirs(parent, exist_ok=True)
    out.save(output_image_filename)
    return output_image_filename
