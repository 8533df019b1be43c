"""
Batch inference for the port (counterpart of
megadetector_tpu/detection/run_detector_batch.py load_and_run_detector_batch,
write_results_to_file and the CLI).

Loader workers decode and letterbox the images into a bounded queue while
the consumer (the calling thread) packs batches per canvas shape and runs
the TorchDetector's device program on them, so decoding overlaps the
device. The consumer takes the images in input order (loader threads run
at most queue_depth images ahead), so the batches, and the results, do not
depend on the loaders' timing. The loader pool is threads (each takes
every loader_workers-th image; PIL and cv2 release the GIL for their heavy
parts) or, with
loader_pool_type='process', spawned processes running the torch-free
_loader_worker (worth it when the decode saturates the GIL: many cores,
large JPEGs; each canvas is pickled back through a pipe). use_native_loader
decodes, rotates and letterboxes JPEGs in C++ on libjpeg (native/); it
needs g++ and libjpeg's header, and raises NativeLoaderError naming the
missing piece without them. Images it hands to PIL (a non-RGB JPEG, a
mirrored EXIF orientation, a decode error) are counted in
native_fallbacks.

Inputs are file paths, a folder, a .json/.txt list file, or in-memory
(image_id, HWC uint8 array) pairs (those always load on threads). The
MD-format 1.6 writer has the reference's ordering, precision and failure
semantics. A long run checkpoints every N images to a JSON file
({'checkpoint': [image dicts]}, the JAX package's format) and resumes from
it (results=; the CLI's --resume_from_checkpoint, 'auto' taking the newest
md_checkpoint*.json beside the output); images already in the results are
skipped. augment runs the detector's test-time augmentation.
include_exif_data and include_image_timestamp read EXIF on the thread
loaders.

With more than one card, use_mesh (default true) attaches a mesh over
every local card to a detector loaded here (the detector's
attach_auto_mesh, the JAX driver's auto-mesh): batch_size rounds up to a
multiple of the card count, each batch splits into one equal shard a
card, and the tail buckets merge at the mesh multiple. One card runs as
before.
"""

import argparse
import collections
import copy
import json
import os
import queue
import shutil
import sys
import threading
import time
import traceback

from datetime import datetime

from megadetector_tpu_torch.detection.run_detector import (
    DEFAULT_DETECTOR_LABEL_MAP,
    FAILURE_IMAGE_OPEN,
    load_detector,
)
from megadetector_tpu_torch.models.registry import (
    DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD,
    get_detector_metadata_from_version_string,
    get_detector_version_from_filename,
)
from megadetector_tpu_torch.utils import ct_utils, path_utils

# MD results format version emitted by write_results_to_file
CURRENT_FORMAT_VERSION = '1.6'

# Images the native loader handed to PIL, over every run (the caller
# resets it; the kernels' launch counters work the same way)
native_fallbacks = 0


def _load_and_preprocess(detector, item, image_size=None, read_exif=False):
    """
    (image_id, preprocess_image() dict) for a file path or an
    (image_id, array) pair; the dict is replaced by the failure string
    when the image cannot be read or letterboxed. With [read_exif] a
    file's EXIF tags go into the dict as 'exif_metadata'.
    """

    exif_data = None
    if isinstance(item, (tuple, list)):
        image_id, image = item
    else:
        image_id = item
        from megadetector_tpu_torch.visualization import \
            visualization_utils
        try:
            image = visualization_utils.load_image(item)
        except Exception:
            return image_id, FAILURE_IMAGE_OPEN
        if read_exif:
            from megadetector_tpu_torch.utils.read_exif import read_pil_exif
            try:
                exif_data = read_pil_exif(image)
            except Exception:
                exif_data = None
    try:
        info = detector.preprocess_image(image, image_id=image_id,
                                         image_size=image_size)
    except Exception:
        return image_id, FAILURE_IMAGE_OPEN
    if exif_data is not None:
        info['exif_metadata'] = exif_data
    return image_id, info


def _item_id(item):
    """The image id of an input: the path, or a pair's image_id."""

    return item[0] if isinstance(item, (tuple, list)) else item


def _enumerate_inputs(image_file_names):
    """A folder, a .json/.txt list file or one path -> list of inputs."""

    if not isinstance(image_file_names, str):
        return list(image_file_names)
    if os.path.isdir(image_file_names):
        return path_utils.find_images(image_file_names, recursive=True)
    if image_file_names.endswith(('.json', '.txt')):
        return path_utils.read_list_from_file(image_file_names)
    return [image_file_names]


#%% Checkpointing
#
# The file format is contractual: {'checkpoint': [image dicts]}


def write_checkpoint(checkpoint_path, results):
    """
    Write [results] to [checkpoint_path], first backing up any previous
    checkpoint to '<path>_tmp' so a mid-write crash can't lose both.
    """

    checkpoint_tmp_path = None
    if os.path.isfile(checkpoint_path):
        checkpoint_tmp_path = checkpoint_path + '_tmp'
        shutil.copyfile(checkpoint_path, checkpoint_tmp_path)

    ct_utils.write_json(checkpoint_path,
                        {'checkpoint': [r for r in results
                                        if r is not None]},
                        force_str=True)

    if checkpoint_tmp_path is not None:
        os.remove(checkpoint_tmp_path)


def load_checkpoint(checkpoint_path):
    """Read a checkpoint file; returns the list of image results."""

    with open(checkpoint_path) as f:
        saved = json.load(f)
    if 'checkpoint' not in saved:
        raise ValueError('Checkpoint file {} is invalid (no "checkpoint" '
                         'field)'.format(checkpoint_path))
    return saved['checkpoint']


#%% The loader pool


def _put(q, item, stop):
    """Put [item] on the bounded queue unless the consumer has stopped;
    False when it has."""

    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            pass
    return False


class _Window:
    """
    The loaders' look-ahead: a loader thread takes image i only once i <
    first + size, where first is the first image the consumer has not
    taken yet. The consumer takes the images in input order, so batches,
    and so the results, never depend on the loaders' timing, and it holds
    at most [size] images that arrived early.
    """

    def __init__(self, size, stop):
        self.size = max(1, int(size))
        self.first = 0
        self.stop = stop
        self.cond = threading.Condition()

    def wait_for(self, i):
        """Block until image i is inside the window; False on stop."""

        with self.cond:
            while i >= self.first + self.size and not self.stop.is_set():
                self.cond.wait(0.1)
        return not self.stop.is_set()

    def advance(self, first):
        with self.cond:
            self.first = first
            self.cond.notify_all()


def _worker_args(detector, image_size, use_native_loader):
    """The settings the loader worker needs, after the file name."""

    return (image_size or detector.default_image_size,
            detector.letterbox_stride, detector.compatibility_mode,
            getattr(detector, 'preprocess_mode', 'host'),
            getattr(detector, 'max_staging_side', None), use_native_loader,
            getattr(detector, 'canvas_mode', 'square'),
            getattr(detector, 'max_canvases', None))


def _start_loaders(detector, items, image_size, n_workers, q, window,
                   pool_type, use_native_loader, read_exif):
    """
    Start the loaders, which put (index, image_id, info or failure
    string, native_fallback) on [q] and then one sentinel (None) per
    worker, also when they fail; the images a failed loader never
    delivered arrive as failures. Loader threads stay inside [window]; a
    process pool holds at most window.size images and delivers them in
    input order. Returns the started threads.
    """

    stop = window.stop

    from megadetector_tpu_torch.detection import _loader_worker

    n_images = len(items)
    worker_args = _worker_args(detector, image_size, use_native_loader)

    if pool_type == 'process':
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        def pump():
            # spawn, not fork: this process runs CUDA and threads. At most
            # window.size images are in the pool at once, so a slow
            # consumer never piles finished images up in memory. A broken
            # pool (a killed child, a spawn failure) fails the images it
            # never delivered; the sentinels go out in finally
            delivered = 0
            try:
                with ProcessPoolExecutor(
                        max_workers=n_workers,
                        mp_context=multiprocessing.get_context(
                            'spawn')) as pool:
                    submitted = collections.deque()
                    for i in range(n_images):
                        while len(submitted) < window.size and \
                                i + len(submitted) < n_images:
                            submitted.append(pool.submit(
                                _loader_worker.load_and_letterbox,
                                (items[i + len(submitted)],) + worker_args))
                        im_file, info, fell_back = \
                            submitted.popleft().result()
                        if not _put(q, (i, im_file, info, fell_back), stop):
                            pool.shutdown(cancel_futures=True)
                            return
                        delivered = i + 1
            except Exception as e:
                print('Loader pool failure: {}'.format(e))
                traceback.print_exc()
                for j in range(delivered, n_images):
                    if not _put(q, (j, items[j], FAILURE_IMAGE_OPEN, False),
                                stop):
                        return
            finally:
                for _ in range(n_workers):
                    _put(q, None, stop)

        threads = [threading.Thread(target=pump, daemon=True)]
    else:
        def loader(worker_idx):
            delivered = set()
            try:
                for i in range(worker_idx, n_images, n_workers):
                    if not window.wait_for(i):
                        return
                    item = items[i]
                    if use_native_loader and not read_exif and \
                            not isinstance(item, (tuple, list)):
                        # The native call releases the GIL for its whole
                        # decode + rotate + letterbox
                        image_id, info, fell_back = \
                            _loader_worker.load_and_letterbox(
                                (item,) + worker_args)
                    else:
                        image_id, info = _load_and_preprocess(
                            detector, item, image_size=image_size,
                            read_exif=read_exif)
                        fell_back = False
                    if not _put(q, (i, image_id, info, fell_back), stop):
                        return
                    delivered.add(i)
            except Exception as e:
                print('Loader worker failure: {}'.format(e))
                traceback.print_exc()
                for j in range(worker_idx, n_images, n_workers):
                    if j not in delivered and not _put(
                            q, (j, _item_id(items[j]), FAILURE_IMAGE_OPEN,
                                False), stop):
                        return
            finally:
                _put(q, None, stop)

        threads = [threading.Thread(target=loader, args=(w,), daemon=True)
                   for w in range(n_workers)]
    for t in threads:
        t.start()
    return threads


#%% Main API


def load_and_run_detector_batch(model_file,
                                image_file_names,
                                checkpoint_path=None,
                                confidence_threshold=None,
                                checkpoint_frequency=-1,
                                results=None,
                                n_cores=1,
                                use_image_queue=True,
                                quiet=False,
                                image_size=None,
                                batch_size=8,
                                augment=False,
                                include_image_size=False,
                                include_image_timestamp=False,
                                include_exif_data=False,
                                detector_options=None,
                                loader_workers=8,
                                queue_depth=64,
                                loader_pool_type='thread',
                                use_native_loader=False,
                                *,
                                device=None):
    """
    Run a detector over images; returns [results] followed by the new
    MD-format image dicts in input order. The arguments are the JAX
    package's function's, in its order, plus the keyword-only device.

    Args:
        model_file: checkpoint path, known model name, or a detector
            object (anything with preprocess_image)
        image_file_names: list of image paths or (image_id, HWC uint8
            array) pairs, or a folder, or a .json/.txt list file
        checkpoint_path: JSON checkpoint destination (enables resume)
        confidence_threshold: output confidence floor (default 0.005)
        checkpoint_frequency: write a checkpoint every N images and at the
            end (-1: off)
        results: results already made (a loaded checkpoint); their images
            are skipped, and the list is extended and returned
        n_cores: accepted for compatibility; loader_workers sets the pool
        use_image_queue: accepted for compatibility (always queued)
        quiet: no progress lines
        image_size: override the model's inference canvas
        batch_size: images per device program
        augment: test-time augmentation (multi-scale + flip passes merged
            before NMS); needs host preprocessing
        include_image_size: add 'height'/'width' of the original image
        include_image_timestamp: add 'datetime' from the EXIF
            DateTimeOriginal (else DateTime) tag
        include_exif_data: add the EXIF tags as 'exif_metadata'
        detector_options: dict of TorchDetector options (pad_batches_to
            defaults to batch_size)
        loader_workers: loader threads or processes
        queue_depth: size of the bounded queue of preprocessed images
        loader_pool_type: 'thread' or 'process' (spawned processes
            running _loader_worker; EXIF and in-memory pairs need threads
            and switch to them with a note)
        use_native_loader: decode + rotate + letterbox JPEGs with the
            native libjpeg loader (its decode may differ from PIL's by a
            few levels); not with EXIF, which reads through PIL
        device: keyword only; as load_detector
    """

    if confidence_threshold is None:
        confidence_threshold = DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD
    if results is None:
        results = []
    if loader_pool_type not in ('thread', 'process'):
        raise ValueError('loader_pool_type must be thread or process, got '
                         '{!r}'.format(loader_pool_type))
    all_items = _enumerate_inputs(image_file_names)
    already_processed = set(r['file'] for r in results)
    items = [item for item in all_items
             if _item_id(item) not in already_processed]
    if len(items) < len(all_items) and not quiet:
        print('Bypassing {} already-processed images'.format(
            len(all_items) - len(items)))
    if len(items) == 0:
        return results

    read_exif = include_exif_data or include_image_timestamp
    if loader_pool_type == 'process' and read_exif:
        print('Note: EXIF enrichment requires the thread loader pool; '
              'switching loader_pool_type to thread')
        loader_pool_type = 'thread'
    if loader_pool_type == 'process' and any(
            isinstance(item, (tuple, list)) for item in items):
        print('Note: in-memory images load on the thread loader pool; '
              'switching loader_pool_type to thread')
        loader_pool_type = 'thread'
    if use_native_loader:
        # Built once here, before any worker needs it; raises when g++ or
        # libjpeg is missing
        from megadetector_tpu_torch import native
        native.load_library()

    if hasattr(model_file, 'preprocess_image'):
        detector = model_file
    else:
        detector_options = dict(detector_options or {})
        detector_options.setdefault('pad_batches_to', batch_size)
        use_mesh = str(detector_options.pop('use_mesh', 'true')).lower() \
            not in ('false', '0', 'no')
        detector = load_detector(model_file,
                                 detector_options=detector_options,
                                 device=device)
        # Data parallelism over every local card (one card: no change)
        if use_mesh and getattr(detector, 'supports_mesh', False):
            batch_size = detector.attach_auto_mesh(batch_size,
                                                   verbose=not quiet)

    n_workers = max(1, int(loader_workers))
    q = queue.Queue(maxsize=queue_depth)
    stop = threading.Event()
    window = _Window(queue_depth, stop)
    threads = _start_loaders(detector, items, image_size, n_workers, q,
                             window, loader_pool_type, use_native_loader,
                             read_exif)

    new_results = [None] * len(items)
    pending = {}  # canvas shape -> list of (index, image_id, info)
    images_since_checkpoint = 0

    def flush_bucket(bucket):
        nonlocal images_since_checkpoint
        if len(bucket) == 0:
            return
        batch_results = detector.generate_detections_one_batch(
            [p[2] for p in bucket], [p[1] for p in bucket],
            detection_threshold=confidence_threshold,
            image_size=image_size, augment=augment)
        for (idx, _, info), r in zip(bucket, batch_results):
            _augment_result(r, info, include_image_size=include_image_size,
                            include_image_timestamp=include_image_timestamp,
                            include_exif_data=include_exif_data)
            new_results[idx] = r
        images_since_checkpoint += len(bucket)
        bucket.clear()

    def flush_all_pending():
        # Tail-bucket merge: when batches pad to a mesh multiple (or to
        # pad_batches_to), several part-full rect-canvas buckets would
        # each run a padded batch; re-letterboxed onto the square canvas
        # they run as one
        if getattr(detector, 'mesh', None) is not None:
            multiple = int(detector.mesh.devices.size)
        else:
            multiple = int(getattr(detector, 'pad_batches_to', None) or 1)
        if multiple > 1:
            small = [b for b in pending.values()
                     if b and len(b) % multiple != 0]
            if len(small) > 1 and sum(len(b) for b in small) <= batch_size:
                merged = []
                for b in small:
                    for idx, image_id, info in b:
                        new_info = detector.repreprocess_on_square_canvas(
                            info, image_size=image_size)
                        if new_info is None:
                            merged = None
                            break
                        merged.append((idx, image_id, new_info))
                    if merged is None:
                        break
                if merged is not None:
                    for b in small:
                        b.clear()
                    pending.setdefault('_merged_square', []).extend(merged)
        for bucket in pending.values():
            flush_bucket(bucket)

    def take(idx, image_id, info, fell_back):
        global native_fallbacks
        nonlocal images_since_checkpoint
        native_fallbacks += int(fell_back)
        if isinstance(info, str):
            new_results[idx] = {'file': image_id, 'detections': None,
                                'failure': info}
        else:
            bucket = pending.setdefault(tuple(info['target_shape']), [])
            bucket.append((idx, image_id, info))
            if len(bucket) >= batch_size:
                flush_bucket(bucket)

        if checkpoint_frequency > 0 and checkpoint_path is not None and \
                images_since_checkpoint >= checkpoint_frequency:
            flush_all_pending()
            done = [r for r in new_results if r is not None]
            write_checkpoint(checkpoint_path, results + done)
            if not quiet:
                print('Wrote checkpoint after {} images'.format(len(done)))
            images_since_checkpoint = 0

    # Images are taken in input order; those that arrive early wait here
    arrived = {}
    n_taken = 0
    n_sentinels = 0
    try:
        while n_sentinels < n_workers:
            item = q.get()
            if item is None:
                n_sentinels += 1
                continue
            arrived[item[0]] = item
            while n_taken in arrived:
                take(*arrived.pop(n_taken))
                n_taken += 1
            window.advance(n_taken)
        flush_all_pending()
    finally:
        # On an error or an interrupt the loaders stop at their next put
        stop.set()
        for t in threads:
            t.join()

    if any(r is None for r in new_results):
        raise RuntimeError('Internal error: {} images were never '
                           'processed'.format(new_results.count(None)))
    results.extend(new_results)
    # A final checkpoint, so a crash after inference loses nothing
    if checkpoint_frequency > 0 and checkpoint_path is not None:
        write_checkpoint(checkpoint_path, results)
    return results


def get_image_datetime(image):
    """
    The EXIF DateTimeOriginal of a PIL image (or filename) as a
    'YYYY:MM:DD HH:MM:SS' string, or None when it is absent or malformed.
    """

    from megadetector_tpu_torch.utils.read_exif import read_pil_exif

    try:
        datetime_str = read_pil_exif(image)['DateTimeOriginal']
        time.strptime(datetime_str, '%Y:%m:%d %H:%M:%S')
        return datetime_str
    except Exception:
        return None


def _augment_result(r, info, include_image_size=False,
                    include_image_timestamp=False, include_exif_data=False):
    """Attach the size, timestamp and EXIF fields asked for to an image
    result."""

    if not isinstance(info, dict):
        return
    if include_image_size and \
            ('original_shape' in info or 'scaling_shape' in info):
        shape = info.get('original_shape', info.get('scaling_shape'))
        r['height'] = int(shape[0])
        r['width'] = int(shape[1])
    exif = info.get('exif_metadata', None)
    if include_exif_data and exif is not None:
        r['exif_metadata'] = exif
    if include_image_timestamp and exif is not None:
        dt = exif.get('DateTimeOriginal', exif.get('DateTime', None))
        if dt is not None:
            r['datetime'] = str(dt)


def write_results_to_file(results,
                          output_file,
                          relative_path_base=None,
                          detector_file=None,
                          info=None,
                          include_max_conf=False,
                          custom_metadata=None,
                          force_forward_slashes=True,
                          detection_categories=None):
    """
    Write detection results in the MD output format 1.6: relative paths,
    forward slashes, filename-sorted images, conf-sorted detections,
    max_detection_conf stripped unless requested, failures with
    detections=None. Returns the dict that was written.
    """

    if relative_path_base is not None:
        results_relative = []
        for r in results:
            r_relative = copy.copy(r)
            r_relative['file'] = os.path.relpath(
                r_relative['file'], start=relative_path_base)
            results_relative.append(r_relative)
        results = results_relative

    if force_forward_slashes:
        results_converted = []
        for r in results:
            r_converted = copy.copy(r)
            r_converted['file'] = r_converted['file'].replace('\\', '/')
            results_converted.append(r_converted)
        results = results_converted

    if info is None:
        info = {
            'detection_completion_time':
                datetime.now().strftime('%Y-%m-%d %H:%M:%S'),
            'format_version': CURRENT_FORMAT_VERSION,
        }
        if detector_file is not None:
            detector_filename = os.path.basename(detector_file)
            detector_version = get_detector_version_from_filename(
                detector_filename)
            info['detector'] = detector_filename
            info['detector_metadata'] = \
                get_detector_metadata_from_version_string(detector_version)
        else:
            info['detector'] = 'unknown'
            info['detector_metadata'] = \
                get_detector_metadata_from_version_string('unknown')
    elif detector_file is not None:
        print('Warning (write_results_to_file): info struct and detector '
              'file supplied, ignoring detector file')

    if custom_metadata is not None:
        info['custom_metadata'] = custom_metadata

    if not include_max_conf:
        for im in results:
            if 'max_detection_conf' in im:
                del im['max_detection_conf']

    results = ct_utils.sort_list_of_dicts_by_key(results, 'file')
    for im in results:
        if im.get('detections') is not None:
            im['detections'] = ct_utils.sort_list_of_dicts_by_key(
                im['detections'], 'conf', reverse=True)
    for im in results:
        if 'failure' in im:
            if im.get('detections') is not None:
                raise ValueError('Illegal failure/detection combination '
                                 'for {}'.format(im['file']))
            im['detections'] = None

    final_output = {
        'images': results,
        'detection_categories':
            detection_categories if detection_categories is not None
            else DEFAULT_DETECTOR_LABEL_MAP,
        'info': info,
    }
    out_dir = os.path.dirname(output_file)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    ct_utils.write_json(output_file, final_output, force_str=True)
    print('Output file saved at {}'.format(output_file))
    return final_output


def main(argv=None):
    """The CLI; [argv] defaults to sys.argv[1:]."""

    parser = argparse.ArgumentParser(
        description='Run MegaDetector (PyTorch port) on a folder or list of '
                    'images, writing MD-format JSON')
    parser.add_argument('detector_file',
                        help='converted .npz checkpoint or known model name')
    parser.add_argument('image_file',
                        help='folder of images, a single image, or a '
                             '.json/.txt list of image paths')
    parser.add_argument('output_file', help='output .json path')
    parser.add_argument('--recursive', action='store_true',
                        help='recurse into image_file when it is a folder')
    parser.add_argument('--output_relative_filenames', action='store_true',
                        help='write paths relative to the input folder')
    parser.add_argument('--include_max_conf', action='store_true')
    parser.add_argument('--include_image_size', action='store_true')
    parser.add_argument('--quiet', action='store_true')
    parser.add_argument('--image_size', type=int, default=None)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--augment', action='store_true',
                        help='test-time augmentation (multi-scale + '
                             'flip passes merged before NMS)')
    parser.add_argument('--threshold', type=float, default=None,
                        help='output confidence floor (default {})'.format(
                            DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD))
    parser.add_argument('--checkpoint_frequency', type=int, default=-1)
    parser.add_argument('--checkpoint_path', default=None)
    parser.add_argument('--resume_from_checkpoint', default=None,
                        help='checkpoint file to resume from, or "auto"')
    parser.add_argument('--allow_checkpoint_overwrite',
                        action='store_true',
                        help='accepted for compatibility; no effect')
    parser.add_argument('--ncores', type=int, default=0,
                        help='(compatibility) loader workers when > 0')
    parser.add_argument('--loader_workers', type=int, default=8,
                        help='loader threads or processes')
    parser.add_argument('--loader_pool_type', default='thread',
                        choices=['thread', 'process'],
                        help='thread (default) or spawned processes, for '
                             'when the decode saturates the GIL')
    parser.add_argument('--use_native_loader', action='store_true',
                        help='decode + letterbox JPEGs with the native '
                             'libjpeg loader (needs g++ and libjpeg\'s '
                             'header; its decode may differ from PIL\'s '
                             'by a few levels)')
    parser.add_argument('--use_image_queue', action='store_true',
                        help='(compatibility) images always go through '
                             'the loaders\' queue')
    parser.add_argument('--preprocess_on_image_queue',
                        action='store_true',
                        help='(compatibility) preprocessing always runs '
                             'on the loader workers')
    parser.add_argument('--include_image_timestamp', action='store_true')
    parser.add_argument('--include_exif_data', action='store_true')
    parser.add_argument('--overwrite_handling', default='overwrite',
                        choices=['overwrite', 'skip', 'error'],
                        help='what to do when output_file exists')
    parser.add_argument('--device', default=None,
                        help='cuda, cuda:N or cpu (default: cuda, which '
                             'needs a card)')
    parser.add_argument('--class_mapping_filename', default=None,
                        help='JSON {category_id: name} to use instead of '
                             'the default label map (implies '
                             'use_model_native_classes)')
    parser.add_argument('--detector_options', nargs='*', default=None)
    parser.add_argument('--previous_results_file', default=None,
                        help='merge results for already-processed images '
                             'from this file')

    if argv is None:
        argv = sys.argv[1:]
    if len(argv) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args(argv)

    if os.path.exists(args.output_file):
        if args.overwrite_handling == 'skip':
            print('Output file {} exists, skipping'.format(
                args.output_file))
            return
        if args.overwrite_handling == 'error':
            raise ValueError('Output file {} exists'.format(
                args.output_file))

    detector_options = ct_utils.parse_kvp_list(args.detector_options)
    custom_category_map = None
    if args.class_mapping_filename is not None:
        with open(args.class_mapping_filename) as f:
            custom_category_map = json.load(f)
        detector_options['use_model_native_classes'] = 'true'

    if os.path.isdir(args.image_file):
        image_file_names = path_utils.find_images(args.image_file,
                                                  args.recursive)
        source_folder = args.image_file
    else:
        image_file_names = _enumerate_inputs(args.image_file)
        source_folder = None
    print('Running detector on {} images'.format(len(image_file_names)))

    # Resume support
    results = []
    checkpoint_path = args.checkpoint_path
    if args.checkpoint_frequency > 0 and checkpoint_path is None:
        output_dir = os.path.dirname(os.path.abspath(args.output_file))
        checkpoint_path = os.path.join(
            output_dir, 'md_checkpoint_{}.json'.format(
                datetime.now().strftime('%Y%m%d%H%M%S')))
    if args.resume_from_checkpoint is not None:
        if args.resume_from_checkpoint == 'auto':
            output_dir = os.path.dirname(os.path.abspath(args.output_file))
            candidates = sorted(
                fn for fn in os.listdir(output_dir)
                if fn.startswith('md_checkpoint') and fn.endswith('.json'))
            if not candidates:
                raise ValueError('No checkpoint files found in {} for '
                                 '"auto" resume'.format(output_dir))
            resume_file = os.path.join(output_dir, candidates[-1])
        else:
            resume_file = args.resume_from_checkpoint
        results = load_checkpoint(resume_file)
        print('Restored {} results from checkpoint {}'.format(
            len(results), resume_file))
        if checkpoint_path is None:
            checkpoint_path = resume_file

    # Merge previous results
    if args.previous_results_file is not None:
        with open(args.previous_results_file) as f:
            previous = json.load(f)
        prev_images = previous.get('images', [])
        if source_folder is not None:
            for im in prev_images:
                im['file'] = os.path.join(source_folder, im['file'])
        results.extend(prev_images)
        print('Merged {} previous results'.format(len(prev_images)))

    loader_workers = args.ncores if args.ncores > 0 else args.loader_workers
    start_time = time.time()
    results = load_and_run_detector_batch(
        args.detector_file, image_file_names,
        checkpoint_path=checkpoint_path,
        confidence_threshold=args.threshold,
        checkpoint_frequency=args.checkpoint_frequency, results=results,
        quiet=args.quiet, image_size=args.image_size,
        batch_size=args.batch_size, augment=args.augment,
        include_image_size=args.include_image_size,
        include_image_timestamp=args.include_image_timestamp,
        include_exif_data=args.include_exif_data,
        detector_options=detector_options, loader_workers=loader_workers,
        loader_pool_type=args.loader_pool_type,
        use_native_loader=args.use_native_loader, device=args.device)
    elapsed = time.time() - start_time
    n_images = len(image_file_names)
    print('Finished inference for {} images in {:.1f}s ({:.2f} images/sec)'
          .format(n_images, elapsed, n_images / elapsed if elapsed > 0
                  else 0))

    write_results_to_file(
        results, args.output_file,
        relative_path_base=source_folder
        if args.output_relative_filenames else None,
        detector_file=args.detector_file,
        include_max_conf=args.include_max_conf,
        detection_categories=custom_category_map)

    # Delete the checkpoint on success
    if checkpoint_path is not None and os.path.isfile(checkpoint_path):
        os.remove(checkpoint_path)
        print('Deleted checkpoint file {}'.format(checkpoint_path))


if __name__ == '__main__':
    main()
