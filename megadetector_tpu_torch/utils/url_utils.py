"""
URL download helpers (model fetching, test-data fetching).

Behavioral contract follows the reference downloader
(reference: megadetector/utils/url_utils.py:69,208): download to a
destination file with progress, optional size verification, and a parallel
multi-URL path. The port's copy of megadetector_tpu/utils/url_utils.py.
"""

import os
import tempfile
import urllib.parse
import urllib.request

from concurrent.futures import ThreadPoolExecutor


def get_temp_folder(preferred_name='megadetector_tpu_torch'):
    """A writable scratch folder under the system temp dir."""

    folder = os.path.join(tempfile.gettempdir(), preferred_name)
    os.makedirs(folder, exist_ok=True)
    return folder


def download_url(url, destination_filename=None, progress_updater=None,
                 force_download=False, verbose=False, escape_spaces=True):
    """
    Download [url] to [destination_filename] (or a temp file named after the
    URL). Skips the download when the destination exists unless
    force_download. Returns the destination filename.
    """

    if escape_spaces:
        url = url.replace(' ', '%20')

    if destination_filename is None:
        target_name = url.replace('://', '_').replace('/', '_') \
            .replace('?', '_')
        destination_filename = os.path.join(get_temp_folder(), target_name)

    if os.path.isfile(destination_filename) and not force_download:
        if verbose:
            print('Bypassing download of already-downloaded file {}'.format(
                os.path.basename(url)))
        return destination_filename

    if verbose:
        print('Downloading file {} to {}'.format(
            os.path.basename(url), destination_filename), end='')

    os.makedirs(os.path.dirname(os.path.abspath(destination_filename)),
                exist_ok=True)

    temp_filename = destination_filename + '.partial'
    try:
        urllib.request.urlretrieve(url, temp_filename, progress_updater)
        os.replace(temp_filename, destination_filename)
    finally:
        if os.path.isfile(temp_filename):
            os.remove(temp_filename)

    assert os.path.isfile(destination_filename)
    if verbose:
        n_bytes = os.path.getsize(destination_filename)
        print('...done, {} bytes.'.format(n_bytes))

    return destination_filename


def download_relative_filename(url, output_base, verbose=False):
    """
    Download [url] to a path under [output_base] that mirrors the URL's path
    component. Returns the local filename.
    """

    parsed = urllib.parse.urlparse(url)
    relative_filename = parsed.path.lstrip('/')
    destination_filename = os.path.join(output_base, relative_filename)
    return download_url(url, destination_filename, verbose=verbose)


def parallel_download_urls(url_to_target_file, verbose=False,
                           overwrite=False, n_workers=20, pool_type='thread'):
    """
    Download many URLs concurrently given a {url: target_file} mapping.
    Returns {url: {'status': 'success'|'error', 'target_file': ...}}.
    """

    results = {}

    def _one(item):
        url, target = item
        try:
            download_url(url, target, force_download=overwrite,
                         verbose=verbose)
            return url, {'status': 'success', 'target_file': target}
        except Exception as e:
            return url, {'status': 'error', 'target_file': target,
                         'error': str(e)}

    items = list(url_to_target_file.items())
    if n_workers <= 1:
        pairs = [_one(i) for i in items]
    else:
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            pairs = list(pool.map(_one, items))
    for url, r in pairs:
        results[url] = r
    return results


def test_urls(urls, error_on_failure=True, timeout=2.0):
    """
    Check that each URL is reachable (HTTP status < 400). Returns a list of
    status codes (or -1 for failures).
    """

    status_codes = []
    for url in urls:
        try:
            req = urllib.request.Request(url, method='HEAD')
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                status_codes.append(resp.status)
        except Exception as e:
            if error_on_failure:
                raise ValueError('Error accessing {}: {}'.format(url, e))
            status_codes.append(-1)
    return status_codes


def get_url_size(url, timeout=30):
    """
    Content-Length of [url] via a HEAD request, or None when the server
    doesn't report one / the request fails
    (reference: url_utils.py:get_url_size).
    """

    import urllib.request
    req = urllib.request.Request(url, method='HEAD')
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            size = resp.headers.get('Content-Length')
            return int(size) if size is not None else None
    except Exception:
        return None


def get_url_sizes(urls, n_workers=8, timeout=30):
    """{url: size-or-None} with a thread pool
    (reference: url_utils.py:get_url_sizes)."""

    from concurrent.futures import ThreadPoolExecutor

    if n_workers <= 1 or len(urls) <= 1:
        sizes = [get_url_size(u, timeout=timeout) for u in urls]
    else:
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            sizes = list(pool.map(
                lambda u: get_url_size(u, timeout=timeout), urls))
    return dict(zip(urls, sizes))


#%% Progress + local-server helpers


class DownloadProgressBar:
    """
    urlretrieve-style progress callback (reference:
    url_utils.py:37-66): an instance is passed as the reporthook and
    prints the share downloaded at each tenth (the port does not use
    tqdm, which the JAX module's bar needs).
    """

    def __init__(self):
        self.tenths = None

    def __call__(self, block_num, block_size, total_size):
        if total_size <= 0:
            return
        tenth = min(10, block_num * block_size * 10 // total_size)
        if self.tenths is None or tenth > self.tenths:
            self.tenths = tenth
            print('Downloading: {}%'.format(10 * tenth))


import http.server  # noqa: E402


class QuietHTTPRequestHandler(http.server.SimpleHTTPRequestHandler):
    """
    SimpleHTTPRequestHandler subclass that suppresses console printouts
    (reference: url_utils.py:462-470).
    """

    def log_message(self, format, *args):
        pass


class SingletonHTTPServer:
    """
    HTTP server serving one local folder on a local port, as a
    singleton: starting a server on a new folder stops the previous one
    (reference: url_utils.py:473-544 — used to serve preview folders
    whose file paths exceed browser URL-length comfort).
    """

    _server = None
    _thread = None

    @classmethod
    def start_server(cls, directory, port=8000, host='localhost'):
        """Start (or restart) the server; returns the base URL."""

        import socketserver
        import threading
        from functools import partial

        cls.stop_server()
        handler = partial(QuietHTTPRequestHandler, directory=directory)
        socketserver.TCPServer.allow_reuse_address = True
        cls._server = socketserver.TCPServer((host, port), handler)
        cls._thread = threading.Thread(target=cls._server.serve_forever)
        cls._thread.daemon = True
        cls._thread.start()
        print('Serving {} at http://{}:{}'.format(directory, host, port))
        return 'http://{}:{}'.format(host, port)

    @classmethod
    def stop_server(cls):
        """Stop the running server instance, if any."""

        if cls._server is not None:
            cls._server.shutdown()
            cls._server.server_close()
            cls._server = None
        if cls._thread is not None:
            cls._thread.join(timeout=5)
            cls._thread = None
