"""
Image and video enumeration for the port: its own copy of
megadetector_tpu/utils/path_utils.py find_images, read_list_from_file,
the video helpers (VIDEO_EXTENSIONS, is_video_file, find_video_strings,
find_videos) and flatten_path.
"""

import glob
import json
import os

# The image extensions of the MD enumeration contract
IMG_EXTENSIONS = ('.jpg', '.jpeg', '.gif', '.png', '.tif', '.tiff', '.bmp',
                  '.webp', '.avif')
VIDEO_EXTENSIONS = ('.mp4', '.avi', '.mpeg', '.mpg', '.mov', '.mkv', '.flv')
SEPARATOR_CHARS = r':\/'


def _is_image_file(s):
    return os.path.splitext(s)[1].lower() in IMG_EXTENSIONS


def find_images(dirname, recursive=False, return_relative_paths=False,
                convert_slashes=True):
    """
    Image files in [dirname]: sorted, forward slashes by default, absolute
    paths unless return_relative_paths.
    """

    if not os.path.isdir(dirname):
        raise ValueError('{} is not a folder'.format(dirname))
    pattern = os.path.join(dirname, '**', '*.*') if recursive \
        else os.path.join(dirname, '*.*')
    images = [s for s in glob.glob(pattern, recursive=recursive)
              if _is_image_file(s)]
    if return_relative_paths:
        images = [os.path.relpath(fn, dirname) for fn in images]
    images = sorted(images)
    if convert_slashes:
        images = [fn.replace('\\', '/') for fn in images]
    return images


def read_list_from_file(filename):
    """A list of strings from a newline-delimited file or a .json list."""

    if filename.endswith('.json'):
        with open(filename, 'r') as f:
            out = json.load(f)
        if not isinstance(out, list):
            raise ValueError('{} does not hold a JSON list'.format(filename))
        return out
    with open(filename, 'r') as f:
        return [line.strip() for line in f if len(line.strip()) > 0]


def is_video_file(s, video_extensions=VIDEO_EXTENSIONS):
    """True if the filename [s] has a video extension (case-insensitive)."""

    return os.path.splitext(s)[1].lower() in video_extensions


def find_video_strings(strings):
    """Subset of [strings] that look like video filenames."""

    return [s for s in strings if is_video_file(s)]


def find_videos(dirname, recursive=False, return_relative_paths=False,
                convert_slashes=True):
    """Find video files in [dirname]; same conventions as find_images."""

    assert os.path.isdir(dirname), '{} is not a folder'.format(dirname)

    pattern = os.path.join(dirname, '**', '*.*') if recursive \
        else os.path.join(dirname, '*.*')
    videos = find_video_strings(glob.glob(pattern, recursive=recursive))
    if return_relative_paths:
        videos = [os.path.relpath(fn, dirname) for fn in videos]
    videos = sorted(videos)
    if convert_slashes:
        videos = [fn.replace('\\', '/') for fn in videos]
    return videos


def flatten_path(pathname, separator_chars=SEPARATOR_CHARS,
                 separator_char_replacement='~'):
    """Replace path separators with [separator_char_replacement]."""

    s = pathname
    for c in separator_chars:
        s = s.replace(c, separator_char_replacement)
    return s
