"""
Write a list of images (with optional titles and links) to a simple HTML
gallery page, splitting across multiple pages when large.

Behavioral contract follows the reference
(megadetector/utils/write_html_image_list.py:24): options control page
size, image style, and headers; each image entry is a dict with
'filename' plus optional 'title', 'imageStyle', 'linkTarget', 'textStyle'.

The port's own copy of megadetector_tpu/utils/write_html_image_list.py:
the same public names, signatures, defaults and output bytes.
"""

import math
import os


def write_html_image_list(filename=None, images=None, options=None):
    """
    Write [images] to an HTML gallery at [filename].

    Args:
        filename: output .html path
        images: list of str filenames or dicts with 'filename' and
            optional 'title', 'imageStyle', 'textStyle', 'linkTarget'
        options: dict with optional keys:
            'headerHtml', 'trailerHtml', 'defaultImageStyle',
            'defaultTextStyle', 'maxFiguresPerHtmlFile', 'encoding'
    """

    if options is None:
        options = {}
    options.setdefault('defaultImageStyle', 'max-width:1200px;')
    options.setdefault('defaultTextStyle', 'font-family:sans-serif;')
    options.setdefault('headerHtml', '')
    options.setdefault('trailerHtml', '')
    options.setdefault('maxFiguresPerHtmlFile', None)
    options.setdefault('encoding', None)

    if images is None:
        images = []

    normalized = []
    for im in images:
        if isinstance(im, str):
            normalized.append({'filename': im})
        else:
            normalized.append(dict(im))

    max_per_page = options['maxFiguresPerHtmlFile']
    if max_per_page is None or len(normalized) <= max_per_page:
        _write_page(filename, normalized, options)
        return [filename]

    # Multi-page: write page files + an index
    n_pages = math.ceil(len(normalized) / max_per_page)
    base, ext = os.path.splitext(filename)
    page_files = []
    for i_page in range(n_pages):
        page_fn = '{}_page{:0>3d}{}'.format(base, i_page, ext)
        chunk = normalized[i_page * max_per_page:
                           (i_page + 1) * max_per_page]
        nav = ' | '.join(
            '<a href="{}">page {}</a>'.format(
                os.path.basename('{}_page{:0>3d}{}'.format(
                    base, j, ext)), j)
            for j in range(n_pages))
        page_options = dict(options)
        page_options['headerHtml'] = options['headerHtml'] + \
            '<p>{}</p>'.format(nav)
        _write_page(page_fn, chunk, page_options)
        page_files.append(page_fn)

    links = ['<a href="{}">Page {} ({} images)</a><br/>'.format(
        os.path.basename(pf), i, max_per_page)
        for i, pf in enumerate(page_files)]
    with open(filename, 'w', encoding=options['encoding']) as f:
        f.write('<html><body>{}\n{}\n{}</body></html>'.format(
            options['headerHtml'], '\n'.join(links),
            options['trailerHtml']))
    return [filename] + page_files


def _write_page(filename, images, options):
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, 'w', encoding=options.get('encoding')) as f:
        f.write('<html><head><meta charset="utf-8"/></head><body>\n')
        f.write(options['headerHtml'])
        for im in images:
            text_style = im.get('textStyle', options['defaultTextStyle'])
            image_style = im.get('imageStyle', options['defaultImageStyle'])
            title = im.get('title', '')
            if title:
                f.write('<p style="{}">{}</p>\n'.format(text_style, title))
            src = im['filename'].replace('\\', '/')
            img_tag = '<img src="{}" style="{}"/>'.format(src, image_style)
            link = im.get('linkTarget')
            if link:
                f.write('<a href="{}">{}</a><br/>\n'.format(
                    link.replace('\\', '/'), img_tag))
            else:
                f.write('{}<br/>\n'.format(img_tag))
        f.write(options['trailerHtml'])
        f.write('</body></html>\n')
