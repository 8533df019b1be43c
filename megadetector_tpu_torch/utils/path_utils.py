"""
Image and video enumeration for the port: its own copy of
megadetector_tpu/utils/path_utils.py find_images, read_list_from_file,
the video helpers (VIDEO_EXTENSIONS, is_video_file, find_video_strings,
find_videos), flatten_path, is_image_file, recursive_file_list,
path_is_abs, and the script and deletion helpers of the Wildlife Insights
download workflow (insert_before_extension, make_executable, delete_file,
parallel_delete_files), unzip_file and safe_create_link for the
taxonomy downloads and the YOLO val runner, and the rest of the JAX
module's public helpers (names and cleaning, hashes, copies, sizes,
folder listings, zip and tar archives, WSL paths, opening files).

Where a helper takes use_threads=False, its process pool is spawned, not
forked (the caller may run CUDA and threads), and its work goes to the
pool as a picklable function (JAX's lambdas cannot reach a process).
"""

import functools
import glob
import hashlib
import json
import multiprocessing
import ntpath
import os
import posixpath
import re
import shutil
import string
import unicodedata
import zipfile

from concurrent.futures import ThreadPoolExecutor, ProcessPoolExecutor

# The image extensions of the MD enumeration contract
IMG_EXTENSIONS = ('.jpg', '.jpeg', '.gif', '.png', '.tif', '.tiff', '.bmp',
                  '.webp', '.avif')
VIDEO_EXTENSIONS = ('.mp4', '.avi', '.mpeg', '.mpg', '.mov', '.mkv', '.flv')
VALID_FILENAME_CHARS = '~-_.() %s%s' % (string.ascii_letters, string.digits)
SEPARATOR_CHARS = r':\/'
VALID_PATH_CHARS = VALID_FILENAME_CHARS + SEPARATOR_CHARS
CHAR_LIMIT = 255


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


#%% The rest of the JAX module's public helpers


def _pool(max_workers, use_threads):
    """A thread pool, or a spawned process pool, of [max_workers]."""

    if use_threads:
        return ThreadPoolExecutor(max_workers=max_workers)
    return ProcessPoolExecutor(
        max_workers=max_workers,
        mp_context=multiprocessing.get_context('spawn'))


def _copy_item(item, overwrite=True, move=False):
    """copy_file of one (src, dst) pair."""

    return copy_file(item[0], item[1], overwrite=overwrite, move=move)


def _get_file_size(filename, verbose=False):
    """(filename, size-in-bytes-or-None) for one file."""

    try:
        return filename, os.path.getsize(filename)
    except OSError as e:
        if verbose:
            print('Error reading size of {}: {}'.format(filename, e))
        return filename, None


def file_list(base_dir, convert_slashes=True, return_relative_paths=False,
              sort_files=True, recursive=False):
    """Alias for recursive_file_list with recursion off by default."""

    return recursive_file_list(base_dir, convert_slashes=convert_slashes,
                               return_relative_paths=return_relative_paths,
                               sort_files=sort_files, recursive=recursive)


def find_image_strings(strings):
    """Subset of [strings] that look like image filenames."""

    return [s for s in strings if is_image_file(s)]


def split_path(path):
    """Split a path into all of its components."""

    parts = []
    while True:
        head, tail = os.path.split(path)
        if tail:
            parts.insert(0, tail)
            path = head
        else:
            if head:
                parts.insert(0, head)
            break
    return parts


def top_level_folder(p):
    """First path component of [p] ('a/b/c' -> 'a'; absolute kept)."""

    parts = split_path(p)
    if len(parts) == 0:
        return ''
    # For absolute paths, include the root with the first component
    if parts[0] in ('/', '\\') and len(parts) > 1:
        return os.path.join(parts[0], parts[1])
    return parts[0]


def clean_filename(filename, allow_list=VALID_FILENAME_CHARS,
                   char_limit=CHAR_LIMIT, force_lower=False,
                   remove_trailing_leading_whitespace=True,
                   replace_whitespace=None):
    """Strip invalid filename characters; optionally lower-case and trim."""

    s = filename
    if remove_trailing_leading_whitespace:
        s = s.strip()
    if replace_whitespace is not None:
        s = re.sub(r'\s', replace_whitespace, s)
    s = unicodedata.normalize('NFKD', s).encode('ASCII', 'ignore').decode()
    s = ''.join(c for c in s if c in allow_list)
    if force_lower:
        s = s.lower()
    return s[:char_limit]


def clean_path(pathname, allow_list=VALID_PATH_CHARS,
               char_limit=CHAR_LIMIT, force_lower=False):
    """clean_filename that preserves path separators."""

    return clean_filename(pathname, allow_list=allow_list,
                          char_limit=char_limit, force_lower=force_lower)


def compute_file_hash(file_path, algorithm='sha256', allow_failures=True):
    """Hash a file's contents; returns hex digest or None on failure."""

    try:
        h = hashlib.new(algorithm)
        with open(file_path, 'rb') as f:
            for chunk in iter(lambda: f.read(1 << 20), b''):
                h.update(chunk)
        return h.hexdigest()
    except Exception:
        if allow_failures:
            return None
        raise


def parallel_compute_file_hashes(filenames, algorithm='sha256',
                                 max_workers=16, use_threads=True,
                                 verbose=False):
    """Hash many files in parallel; returns {filename: digest-or-None}."""

    with _pool(max_workers, use_threads) as pool:
        digests = list(pool.map(
            functools.partial(compute_file_hash, algorithm=algorithm),
            filenames))
    return dict(zip(filenames, digests))


def copy_file(src, dst, overwrite=True, verbose=False, move=False):
    """Copy (or move) a file, creating destination folders as needed."""

    if not overwrite and os.path.exists(dst):
        return dst
    dst_dir = os.path.dirname(dst)
    if len(dst_dir) > 0:
        os.makedirs(dst_dir, exist_ok=True)
    if move:
        shutil.move(src, dst)
    else:
        shutil.copy2(src, dst)
    return dst


def parallel_copy_files(input_file_to_output_file, max_workers=16,
                        use_threads=True, overwrite=False, verbose=False,
                        move=False):
    """Copy many files in parallel given a {src: dst} mapping."""

    items = list(input_file_to_output_file.items())
    with _pool(max_workers, use_threads) as pool:
        list(pool.map(functools.partial(_copy_item, overwrite=overwrite,
                                        move=move), items))


def write_list_to_file(output_file, strings):
    """Write a list of strings to a file, one per line (or .json)."""

    if output_file.endswith('.json'):
        with open(output_file, 'w', newline='\n') as f:
            json.dump(strings, f, indent=1)
    else:
        with open(output_file, 'w', newline='\n') as f:
            for s in strings:
                f.write('{}\n'.format(s))


def zip_file(input_fn, output_fn=None, overwrite=True,
             compress_level=9, verbose=False):
    """Zip a single file; returns the zipfile path."""

    if output_fn is None:
        output_fn = input_fn + '.zip'
    if not overwrite and os.path.exists(output_fn):
        return output_fn
    with zipfile.ZipFile(output_fn, 'w', zipfile.ZIP_DEFLATED,
                         compresslevel=compress_level) as zf:
        zf.write(input_fn, arcname=os.path.basename(input_fn))
    return output_fn


def get_file_sizes(filenames, max_workers=1, use_threads=True,
                   verbose=False, recursive=True, convert_slashes=True,
                   return_relative_paths=True):
    """
    {filename: size in bytes (None on error)} for a list of files, or
    for every file under a folder when [filenames] is a folder path
    (reference: path_utils.py:1215 — folder-or-list input, optional
    worker pool, relative paths only meaningful for folder input).
    """

    folder_name = None
    if isinstance(filenames, str):
        folder_name = filenames
        assert os.path.isdir(folder_name), \
            'Could not find folder {}'.format(folder_name)
        filenames = recursive_file_list(
            folder_name, recursive=recursive, return_relative_paths=False)
    else:
        filenames = list(filenames)

    if max_workers <= 1 or len(filenames) <= 1:
        results = [_get_file_size(fn, verbose=verbose)
                   for fn in filenames]
    else:
        with _pool(min(max_workers, len(filenames)), use_threads) as pool:
            results = list(pool.map(_get_file_size, filenames))

    to_return = {}
    for fn, size in results:
        if return_relative_paths and folder_name is not None:
            fn = os.path.relpath(fn, folder_name)
        if convert_slashes:
            fn = fn.replace('\\', '/')
        to_return[fn] = size
    return to_return


def fileparts(path):
    """'c/d/file.jpg' -> ('c/d', 'file', '.jpg')."""

    folder = os.path.dirname(path)
    base, ext = os.path.splitext(os.path.basename(path))
    return folder, base, ext


def folder_list(base_dir, convert_slashes=True,
                return_relative_paths=False, recursive=False):
    """Sorted folders under [base_dir] (reference: path_utils.py:130)."""

    folders = []
    if recursive:
        for root, dirs, _ in os.walk(base_dir):
            folders.extend(os.path.join(root, d) for d in dirs)
    else:
        folders = [os.path.join(base_dir, d)
                   for d in os.listdir(base_dir)
                   if os.path.isdir(os.path.join(base_dir, d))]
    if return_relative_paths:
        folders = [os.path.relpath(f, base_dir) for f in folders]
    if convert_slashes:
        folders = [f.replace('\\', '/') for f in folders]
    return sorted(folders)


def folder_summary(folder, print_summary=True):
    """
    {'n_files', 'n_folders', 'extension_to_count'} for a folder tree
    (reference: path_utils.py:177).
    """

    from collections import defaultdict

    n_files = 0
    n_folders = 0
    extension_to_count = defaultdict(int)
    for root, dirs, files in os.walk(folder):
        n_folders += len(dirs)
        n_files += len(files)
        for fn in files:
            extension_to_count[os.path.splitext(fn)[1].lower()] += 1
    summary = {'n_files': n_files, 'n_folders': n_folders,
               'extension_to_count': dict(sorted(
                   extension_to_count.items(),
                   key=lambda kv: -kv[1]))}
    if print_summary:
        print('{}: {} files in {} folders'.format(folder, n_files,
                                                  n_folders))
        for ext, n in summary['extension_to_count'].items():
            print('  {}: {}'.format(ext or '(none)', n))
    return summary


def remove_empty_folders(path, remove_root=False):
    """Recursively delete empty folders (reference: path_utils.py:384).
    Returns True when [path] itself was removed."""

    if not os.path.isdir(path):
        return False
    entries = os.listdir(path)
    for entry in entries:
        full = os.path.join(path, entry)
        if os.path.isdir(full):
            remove_empty_folders(full, remove_root=True)
    if remove_root and not os.listdir(path):
        os.rmdir(path)
        return True
    return False


def path_join(*paths, convert_slashes=True):
    """os.path.join with forward-slash output (reference:
    path_utils.py:434)."""

    joined = os.path.join(*paths)
    return joined.replace('\\', '/') if convert_slashes else joined


def test_file_write(fn, overwrite=True):
    """True when [fn] is writable (reference: path_utils.py:454)."""

    if os.path.exists(fn) and not overwrite:
        return False
    try:
        with open(fn, 'a'):
            pass
        return True
    except OSError:
        return False


def is_executable(filename):
    """True when [filename] exists and is executable."""

    return os.path.isfile(filename) and os.access(filename, os.X_OK)


def zip_folder(input_folder, output_fn=None, overwrite=False,
               verbose=False, compress_level=9):
    """Zip a folder tree (reference: path_utils.py:1449)."""

    import zipfile

    if output_fn is None:
        output_fn = input_folder.rstrip('/\\') + '.zip'
    if os.path.isfile(output_fn) and not overwrite:
        if verbose:
            print('Skipping existing zipfile {}'.format(output_fn))
        return output_fn
    if verbose:
        print('Zipping {} to {}'.format(input_folder, output_fn))
    with zipfile.ZipFile(output_fn, 'w', zipfile.ZIP_DEFLATED,
                         compresslevel=compress_level) as zf:
        for root, _, files in os.walk(input_folder):
            for fn in files:
                full = os.path.join(root, fn)
                zf.write(full, os.path.relpath(full, input_folder))
    return output_fn


def zip_files_into_single_zipfile(input_files, output_fn,
                                  arc_name_base=None, overwrite=False,
                                  compress_level=9):
    """Zip a list of files into one archive (reference:
    path_utils.py:1403)."""

    import zipfile

    if os.path.isfile(output_fn) and not overwrite:
        return output_fn
    with zipfile.ZipFile(output_fn, 'w', zipfile.ZIP_DEFLATED,
                         compresslevel=compress_level) as zf:
        for fn in input_files:
            arcname = os.path.relpath(fn, arc_name_base) \
                if arc_name_base else os.path.basename(fn)
            zf.write(fn, arcname)
    return output_fn


def add_files_to_single_tar_file(input_files, output_fn, arc_name_base,
                                 overwrite=False, mode='x'):
    """Tar a list of files (reference: path_utils.py:1361)."""

    import tarfile

    if os.path.isfile(output_fn):
        if not overwrite:
            return output_fn
        os.remove(output_fn)
    with tarfile.open(output_fn, mode) as tf:
        for fn in input_files:
            tf.add(fn, arcname=os.path.relpath(fn, arc_name_base))
    return output_fn


def parallel_zip_files(input_files, max_workers=8, overwrite=False):
    """Zip each file to <file>.zip in parallel (reference:
    path_utils.py:1492)."""

    from concurrent.futures import ThreadPoolExecutor

    def one(fn):
        return zip_file(fn, overwrite=overwrite)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(one, input_files))


def parallel_zip_folders(input_folders, max_workers=8,
                         overwrite=False):
    """Zip each folder to <folder>.zip in parallel (reference:
    path_utils.py:1537)."""

    from concurrent.futures import ThreadPoolExecutor

    def one(folder):
        return zip_folder(folder, overwrite=overwrite)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(one, input_folders))


def zip_each_file_in_folder(folder_name, recursive=False,
                            max_workers=8, overwrite=False,
                            required_token=None):
    """Zip every file in a folder to <file>.zip (reference:
    path_utils.py:1583)."""

    files = file_list(folder_name, recursive=recursive) if recursive \
        else [os.path.join(folder_name, fn)
              for fn in os.listdir(folder_name)
              if os.path.isfile(os.path.join(folder_name, fn))]
    files = [fn for fn in files if not fn.endswith('.zip')]
    if required_token is not None:
        files = [fn for fn in files if required_token in fn]
    return parallel_zip_files(files, max_workers=max_workers,
                              overwrite=overwrite)


def parallel_unzip_files(input_files, max_workers=8):
    """Unzip each archive next to itself in parallel (reference:
    path_utils.py:1647)."""

    from concurrent.futures import ThreadPoolExecutor

    def one(fn):
        return unzip_file(fn, os.path.splitext(fn)[0])

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(one, input_files))


def windows_path_to_wsl_path(path):
    """'c:\\temp\\foo' -> '/mnt/c/temp/foo'
    (reference: path_utils.py:windows_path_to_wsl_path). Returns paths
    without a drive letter unchanged (slashes normalized)."""

    path = str(path).replace('\\', '/')
    if len(path) >= 2 and path[1] == ':':
        path = '/mnt/{}{}'.format(path[0].lower(), path[2:])
    return path


def wsl_path_to_windows_path(path):
    """'/mnt/c/temp/foo' -> 'c:\\temp\\foo'
    (reference: path_utils.py:wsl_path_to_windows_path). Returns None
    for non-/mnt paths like the reference."""

    path = str(path).replace('\\', '/')
    if not path.startswith('/mnt/') or len(path) < 6:
        return None
    drive = path[5]
    rest = path[6:]
    return '{}:{}'.format(drive, rest.replace('/', '\\'))


def open_file_in_chrome(filename):
    """
    Open a file in Chrome regardless of file type (reference:
    path_utils.py:813-960; typically used to preview .html/.md files).
    Tries the usual per-platform Chrome binaries, then falls back to
    the OS default handler. Returns whether an open command was issued.
    """

    import platform
    import shutil
    import subprocess

    abs_path = os.path.abspath(filename)
    system = platform.system()
    if system == 'Windows':
        url = 'file:///{}'.format(abs_path.replace(os.sep, '/'))
        candidates = ['chrome', 'chrome.exe']
    elif system == 'Darwin':
        url = 'file://{}'.format(abs_path)
        candidates = [
            '/Applications/Google Chrome.app/Contents/MacOS/'
            'Google Chrome']
    else:
        url = 'file://{}'.format(abs_path)
        candidates = ['google-chrome', 'google-chrome-stable',
                      'chromium', 'chromium-browser']

    for candidate in candidates:
        chrome = shutil.which(candidate) or (
            candidate if os.path.isfile(candidate) else None)
        if chrome is not None:
            try:
                subprocess.Popen([chrome, url],
                                 stdout=subprocess.DEVNULL,
                                 stderr=subprocess.DEVNULL)
                return True
            except Exception:
                continue

    # Fall back to the OS default handler
    open_file(filename)
    return True


def open_file(filename, attempt_to_open_in_wsl_host=False,
              browser_name=None):
    """
    Open a file in the OS default viewer (xdg-open / start / open);
    failures print a warning instead of raising, since this is a
    convenience for interactive workflows
    (reference: path_utils.py:open_file).
    """

    import subprocess
    import sys as _sys

    try:
        if _sys.platform.startswith('win'):
            os.startfile(filename)  # noqa
        elif _sys.platform == 'darwin':
            subprocess.Popen(['open', filename],
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
        elif attempt_to_open_in_wsl_host:
            from megadetector_tpu_torch.utils.ct_utils import \
                environment_is_wsl
            if environment_is_wsl():
                windows_path = wsl_path_to_windows_path(filename)
                if windows_path is not None:
                    subprocess.Popen(
                        ['wslview', windows_path],
                        stdout=subprocess.DEVNULL,
                        stderr=subprocess.DEVNULL)
                    return
            subprocess.Popen(['xdg-open', filename],
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
        else:
            subprocess.Popen(['xdg-open', filename],
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    except Exception as e:
        print('Warning: could not open {}: {}'.format(filename, e))
