"""
Image loading for the port: its own copy of
megadetector_tpu/visualization/visualization_utils.py load_image. Images are
converted to RGB and EXIF orientation is applied as the MD loader does
(rotate by {3: 180, 6: 270, 8: 90} degrees with expand=True; mirrored
orientations unsupported). PIL is imported only when an image is loaded.
"""

# EXIF tag 274 = Orientation; values map to counterclockwise PIL rotations
EXIF_ORIENTATION_TAG = 274
EXIF_IMAGE_NO_ROTATION = 1
EXIF_IMAGE_ROTATIONS = {3: 180, 6: 270, 8: 90}


def load_image(input_file, ignore_exif_rotation=False):
    """
    Open a local image file (or a binary stream) with PIL, convert it to
    RGB, apply its EXIF orientation and decode the pixels.
    """

    from PIL import Image

    image = Image.open(input_file)
    if image.mode not in ('RGBA', 'RGB', 'L', 'I;16'):
        raise AttributeError(
            'Image {} uses unsupported mode {}'.format(input_file, image.mode))
    if image.mode in ('RGBA', 'L'):
        image = image.convert(mode='RGB')

    if not ignore_exif_rotation:
        try:
            exif = image._getexif()
            orientation = exif.get(EXIF_ORIENTATION_TAG, None)
            if orientation is not None and \
                    orientation != EXIF_IMAGE_NO_ROTATION:
                if orientation not in EXIF_IMAGE_ROTATIONS:
                    raise ValueError('Mirrored rotations are not supported')
                image = image.rotate(
                    EXIF_IMAGE_ROTATIONS[orientation], expand=True)
        except Exception:
            pass

    image.load()
    return image
