"""
Minimal image-search downloader with the reference's Downloader surface
(reference: megadetector/taxonomy_mapping/simple_image_download.py — a
vendored fork of the simple_image_download package used by the
taxonomy-preview tooling). The scrape/fetch layers are injectable
(search_fn/fetch_fn, same pattern as retrieve_sample_image), so the
class constructs and tests offline and activates when egress exists.

The port's own copy of
megadetector_tpu/taxonomy_mapping/simple_image_download.py: the same
public names, signatures, defaults and output bytes.
"""

import os
import random

from megadetector_tpu_torch.taxonomy_mapping.retrieve_sample_image import (
    _default_fetch, _default_search)


def check_webpage(url, fetch_fn=None):
    """
    Fetch [url] and return its bytes if it looks like binary image
    content (not an HTML page), else None (reference:
    simple_image_download.py:60-68).
    """

    fetch_fn = fetch_fn or _default_fetch
    try:
        content = fetch_fn(url)
        if content and b'<html' not in content[:512].lower():
            return content
    except Exception as err:
        print(err)
    return None


class Downloader:
    """
    Image-search downloader (reference:
    simple_image_download.py:73-206): search_urls() scrapes and caches
    candidate URLs per query; download() writes the cached (or
    freshly-searched) images under directory/<query>/.
    """

    def __init__(self, extensions=None, search_fn=None, fetch_fn=None):
        if extensions:
            self._extensions = set(extensions)
        else:
            self._extensions = {'.jpg', '.png', '.ico', '.gif',
                                '.jpeg'}
        self._directory = 'simple_images/'
        self.get_dirs = set()
        self._cached_urls = {}
        self._search_fn = search_fn or _default_search
        self._fetch_fn = fetch_fn or _default_fetch

    @property
    def directory(self):
        return self._directory

    @directory.setter
    def directory(self, value):
        self._directory = value

    @property
    def cached_urls(self):
        return self._cached_urls

    @property
    def extensions(self):
        return self._extensions

    @extensions.setter
    def extensions(self, value):
        self._extensions = set([value])

    def get_urls(self):
        """URLs currently held in the cache."""

        return [self._cached_urls[name][1][0]
                for name in self._cached_urls]

    def generate_dir(self, dir_name):
        """Create (if needed) and return the folder for one query."""

        dir_name = dir_name.replace(' ', '_')
        path = os.path.join(self._directory, dir_name)
        if dir_name not in self.get_dirs:
            os.makedirs(path, exist_ok=True)
            self.get_dirs.add(dir_name)
        return path

    @staticmethod
    def gen_fn(content, name):
        """
        File name for downloaded content, with a random id so the same
        picture imports twice (reference:
        simple_image_download.py:195-202; content sniffing replaces
        the magic dependency).
        """

        rand_id = str(hex(random.randrange(1000)))[2:]
        if content.startswith(b'\x89PNG'):
            ext = '.png'
        elif content.startswith(b'GIF8'):
            ext = '.gif'
        else:
            ext = '.jpeg'
        return '{}_{}{}'.format(name, rand_id, ext)

    def search_urls(self, keywords, limit=1, verbose=False, cache=True,
                    timer=None):
        """
        Search for each comma-separated keyword (a keyword may be a
        multi-word query) and cache {file_name: [folder, (url,
        content)]} entries for the hits that fetch as images
        (reference: simple_image_download.py:123-150).
        """

        cache_out = {}
        search = [str(item).strip()
                  for item in keywords.split(',') if str(item).strip()]
        for query in search:
            path = self.generate_dir(query)
            image_urls = self._search_fn(query, limit + 1)
            for img_url in image_urls[:limit + 1]:
                content = check_webpage(img_url,
                                        fetch_fn=self._fetch_fn)
                if content is not None:
                    file_name = Downloader.gen_fn(content, query)
                    cache_out[file_name] = [path, (img_url, content)]
                    if verbose:
                        print('Found {}'.format(img_url))
        if cache:
            self._cached_urls.update(cache_out)
        return cache_out

    def download(self, keywords=None, limit=1, verbose=False,
                 cache=True, download_cache=False, timer=None):
        """
        Download images for [keywords] (or everything in the cache when
        [download_cache]); returns the list of file paths written
        (reference: simple_image_download.py:152-183).
        """

        if not download_cache:
            content = self.search_urls(keywords, limit, verbose, cache,
                                       timer)
        else:
            content = self._cached_urls
            if not content:
                print('Downloader has no URLs saved in memory yet; '
                      'run Downloader.search_urls first')
        paths = []
        for name, (path, (url, data)) in content.items():
            fullpath = os.path.join(path, name)
            paths.append(fullpath)
            with open(fullpath, 'wb') as f:
                f.write(data)
            if verbose:
                print('Wrote {}'.format(fullpath))
        return paths

    def flush_cache(self):
        """Clear the Downloader instance cache."""

        self._cached_urls = {}
