"""
Image and video enumeration for the port: its own copy of
megadetector_tpu/utils/path_utils.py find_images, read_list_from_file,
the video helpers (VIDEO_EXTENSIONS, is_video_file, find_video_strings,
find_videos), flatten_path, is_image_file, recursive_file_list,
path_is_abs, and the script and deletion helpers of the Wildlife Insights
download workflow (insert_before_extension, make_executable, delete_file,
parallel_delete_files), and unzip_file and safe_create_link for the
taxonomy downloads and the YOLO val runner.
"""

import glob
import json
import ntpath
import os
import posixpath
import re
import zipfile

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


def is_image_file(s, img_extensions=IMG_EXTENSIONS):
    """True if the filename [s] has an image extension (case-insensitive)."""

    return os.path.splitext(s)[1].lower() in img_extensions


def recursive_file_list(base_dir, convert_slashes=True,
                        return_relative_paths=False, sort_files=True,
                        recursive=True):
    """
    List all files under [base_dir]. Forward slashes by default; sorted.
    """

    assert os.path.isdir(base_dir), '{} is not a folder'.format(base_dir)

    all_files = []
    if recursive:
        for root, _, files in os.walk(base_dir):
            for fn in files:
                all_files.append(os.path.join(root, fn))
    else:
        for fn in os.listdir(base_dir):
            full = os.path.join(base_dir, fn)
            if os.path.isfile(full):
                all_files.append(full)

    if return_relative_paths:
        all_files = [os.path.relpath(fn, base_dir) for fn in all_files]
    if convert_slashes:
        all_files = [fn.replace('\\', '/') for fn in all_files]
    if sort_files:
        all_files = sorted(all_files)
    return all_files


def path_is_abs(p):
    """True for absolute paths on either POSIX or Windows conventions."""

    return posixpath.isabs(p) or ntpath.isabs(p) or re.match(r'^[A-Za-z]:', p)


def insert_before_extension(filename, s=None, separator='.'):
    """
    'a/b.jpg' + 'x' -> 'a/b.x.jpg'. When [s] is None, inserts a timestamp.
    """

    if s is None or len(s) == 0:
        import datetime
        s = datetime.datetime.now().strftime('%Y.%m.%d.%H.%M.%S')
    base, ext = os.path.splitext(filename)
    return '{}{}{}{}'.format(base, separator, s, ext)


def delete_file(filename, verbose=False):
    """Delete a file if it exists; never raises for a missing file."""

    try:
        os.remove(filename)
        return True
    except FileNotFoundError:
        return False


def make_executable(filename, catch_exceptions=False):
    """chmod +x (reference: path_utils.py:696)."""

    try:
        os.chmod(filename, os.stat(filename).st_mode | 0o111)
        return True
    except OSError:
        if not catch_exceptions:
            raise
        return False


def parallel_delete_files(input_files, max_workers=8, verbose=False):
    """Delete files in parallel (reference: path_utils.py:1156)."""

    from concurrent.futures import ThreadPoolExecutor

    def one(fn):
        delete_file(fn, verbose=verbose)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        list(pool.map(one, input_files))


def safe_create_link(link_exists, link_new):
    """Create a symlink link_new -> link_exists, replacing a stale one."""

    if os.path.lexists(link_new):
        if os.path.islink(link_new) and os.readlink(link_new) == link_exists:
            return
        os.remove(link_new)
    os.symlink(link_exists, link_new)


def unzip_file(input_file, output_folder=None):
    """Unzip an archive (defaults to a folder named after the zip)."""

    if output_folder is None:
        output_folder = os.path.splitext(input_file)[0]
    os.makedirs(output_folder, exist_ok=True)
    with zipfile.ZipFile(input_file, 'r') as zf:
        zf.extractall(output_folder)
    return output_folder
