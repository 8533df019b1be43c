"""
HTML directory-index generation (reference:
megadetector/utils/directory_listing.py): write an index.html into each
folder of a tree with folder/file links and an image preview.

The port's own copy of megadetector_tpu/utils/directory_listing.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import os
import sys

from megadetector_tpu_torch.utils.path_utils import is_image_file


def _create_plain_index(root, dirs, files, dirname=None):
    """HTML source for one folder's index (folders, files, and a preview
    of the first image when present)."""

    if dirname is None:
        dirname = root or '/'
    dirname = dirname.replace('\\', '/')

    html = "<!DOCTYPE html>\n"
    html += "<html lang='en'><head>"
    html += "<title>Index of {}</title>\n".format(dirname)
    html += "<meta charset='UTF-8'>\n"
    html += "<style>\n"
    html += "body { font-family: Segoe UI, Helvetica, Arial, " \
            "sans-serif; }\na { text-decoration:none; }\n"
    html += "</style>\n</head><body>\n"
    html += "<h1>Index of {}</h1>\n".format(dirname)

    image_files = [f for f in files if is_image_file(f)]
    if image_files:
        html += ("<a href='{0}'><img style='height:200px; "
                 "float:right;' src='{0}' alt='Preview image'></a>\n"
                 .format(image_files[0]))

    if root:
        html += "<p><a href='../index.html'>To parent directory</a></p>\n"

    html += "<h2>Folders</h2>\n"
    for d in sorted(dirs):
        html += "<a href='{0}/index.html'>{0}</a><br/>\n".format(d)
    html += "<h2>Files</h2>\n"
    for f in sorted(files):
        html += "<a href='{0}'>{0}</a><br/>\n".format(f)
    html += "</body></html>\n"
    return html


def create_html_index(dir, overwrite=False, template_fun=None,
                      basepath=None, recursive=True):
    """
    Write an index.html into [dir] (and each subfolder when
    [recursive]), excluding hidden files. [template_fun] takes
    (root, dirs, files[, dirname]) and returns HTML.

    Returns the list of index files written.
    """

    if template_fun is None:
        template_fun = _create_plain_index

    dir = os.path.normpath(dir)
    written = []

    for root, dirs, files in os.walk(dir):
        dirs[:] = sorted(d for d in dirs if not d.startswith('.'))
        files = sorted(f for f in files
                       if not f.startswith('.') and f != 'index.html')
        index_path = os.path.join(root, 'index.html')
        if os.path.isfile(index_path) and not overwrite:
            if not recursive:
                break
            continue
        dirname = os.path.relpath(root, basepath) if basepath else root
        html = template_fun(root if root != dir else '', dirs, files,
                            dirname=dirname)
        with open(index_path, 'w') as f:
            f.write(html)
        written.append(index_path)
        if not recursive:
            break
    return written


def main():
    parser = argparse.ArgumentParser(
        description='Write index.html files into a directory tree')
    parser.add_argument('directory')
    parser.add_argument('--overwrite', action='store_true')
    parser.add_argument('--no_recursion', action='store_true')
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()
    written = create_html_index(args.directory,
                                overwrite=args.overwrite,
                                recursive=not args.no_recursion)
    print('Wrote {} index files'.format(len(written)))


if __name__ == '__main__':
    main()
