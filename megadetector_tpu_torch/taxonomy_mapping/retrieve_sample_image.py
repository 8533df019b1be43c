"""
Retrieve sample images for a species query — the visual sanity check
behind taxonomy-mapping review ("does 'snake' map to a fish?").

Reference role (megadetector/taxonomy_mapping/retrieve_sample_image.py
+ simple_image_download.py): scrape an image search engine for [query]
and save the first N hits. This environment has no egress, so the
downloader is an injectable layer (the same pattern as
utils/url_utils and species_lookup's taxonomy downloads):

- search_fn(query, limit) -> list of image URLs
- fetch_fn(url) -> bytes

The default search_fn implements the reference's Bing-style scrape
(murl extraction from the image-search HTML) over
utils/url_utils.download_url machinery and activates automatically
when egress exists; tests inject fakes.

The port's own copy of
megadetector_tpu/taxonomy_mapping/retrieve_sample_image.py: the same
public names, signatures, defaults and output bytes.
"""

import os
import re
import sys

default_output_folder = os.path.join(
    os.path.expanduser('~'), 'tmp', 'image-download-test')


def _default_search(query, limit):
    """Bing-style image search scrape (the reference's approach):
    fetch the image-search page and pull the murl fields."""

    import urllib.parse
    import urllib.request

    url = ('https://www.bing.com/images/search?q={}&count={}'.format(
        urllib.parse.quote(query), limit))
    req = urllib.request.Request(
        url, headers={'User-Agent': 'Mozilla/5.0'})
    with urllib.request.urlopen(req, timeout=30) as r:
        html = r.read().decode('utf-8', errors='replace')
    return re.findall(r'murl&quot;:&quot;(.*?)&quot;', html)[:limit]


def _default_fetch(url):
    import urllib.request

    req = urllib.request.Request(
        url, headers={'User-Agent': 'Mozilla/5.0'})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def download_images(query, output_directory=default_output_folder,
                    limit=100, verbose=False, search_fn=None,
                    fetch_fn=None):
    """
    Retrieve up to [limit] sample images for [query] into
    [output_directory]. Returns the saved paths. Failures on
    individual URLs are skipped.
    """

    search_fn = search_fn or _default_search
    fetch_fn = fetch_fn or _default_fetch

    os.makedirs(output_directory, exist_ok=True)
    urls = search_fn(query.replace(' ', '+'), limit)

    paths = []
    for i, url in enumerate(urls[:limit]):
        try:
            data = fetch_fn(url)
        except Exception as e:
            if verbose:
                print('Skipping {}: {}'.format(url, e))
            continue
        ext = os.path.splitext(url.split('?')[0])[1].lower()
        if ext not in ('.jpg', '.jpeg', '.png', '.gif'):
            ext = '.jpg'
        out = os.path.join(
            output_directory,
            '{}_{:03d}{}'.format(
                re.sub(r'[^A-Za-z0-9+_-]', '_', query), i, ext))
        with open(out, 'wb') as f:
            f.write(data)
        paths.append(out)
    if verbose:
        print('Saved {} sample images for "{}"'.format(
            len(paths), query))
    return paths


def main():
    import argparse
    parser = argparse.ArgumentParser(
        description='Download sample images for a species query '
                    '(taxonomy-mapping sanity checks)')
    parser.add_argument('query')
    parser.add_argument('--output_directory',
                        default=default_output_folder)
    parser.add_argument('--limit', type=int, default=20)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    download_images(args.query, args.output_directory, args.limit,
                    verbose=True)


if __name__ == '__main__':
    main()
