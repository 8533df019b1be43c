"""
Two-stage pipeline: detect -> crop -> species-classify (counterpart of
megadetector_tpu/detection/run_md_and_classifier.py, with its options,
defaults and CLI, plus --device).

A detection step over the images (detection/run_detector_batch.py) and
videos (detection/process_video.py) of a folder, with one detector loaded
once for both, then a classification step: producer threads decode images
(or re-decode the frames that carry detections) and cut the qualifying
crops into a bounded queue; the main thread classifies them in batches
with one batch in flight (models/classifier.py classify_batch_async),
attaches 'classifications' to each detection and the top-level
'classification_categories' (common names and taxonomy descriptions for
SpeciesNet-style class names), and optionally runs the ensemble
(taxonomy rollup, geofencing).

Crops reach the classifier in input order (image, then detection index):
each producer cuts an image's crops in parallel with the others but puts
them on the queue only in its image's turn. The JAX driver batches crops
in the order its producer threads deliver them, so its batches, and with
quantize=int8 the first batch's calibration and every later result,
depend on thread timing; here they do not (crop_workers 1 and 4 give the
same file).
"""

import argparse
import json
import os
import queue
import sys
import threading
import time

import numpy as np

from megadetector_tpu_torch.detection import process_video as \
    process_video_module
from megadetector_tpu_torch.detection import run_detector_batch
from megadetector_tpu_torch.detection.run_detector import load_detector
from megadetector_tpu_torch.models.classifier import (SpeciesClassifier,
                                                      extract_crop)
from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils import path_utils
from megadetector_tpu_torch.visualization import \
    visualization_utils as vis_utils

DEFAULT_CLASSIFICATION_THRESHOLD = 0.1
DEFAULT_OUTPUT_THRESHOLD = 0.005
# The JAX package's default (the reference's GPU classifier used 8); tail
# batches pad to this size so one program (one CUDA graph) serves every
# flush
DEFAULT_CLASSIFIER_BATCH_SIZE = 64

# Only animal detections get classified by default
DEFAULT_CLASSIFIABLE_CATEGORIES = ('1',)


class MDAndClassifierOptions:
    """Options controlling run_md_and_classifier(). [device] is 'cuda',
    'cuda:N', 'cpu' or None (CUDA; raises without a card), for the
    detector and the classifier. run_md_and_classifier sets
    [step_seconds]: {'detect', 'crop', 'classify', 'total'}, where crop is
    the classifier's wait for crops and classify its own calls."""

    def __init__(self):
        self.input_folder = None
        self.output_file = None
        self.detector_model = 'MDV5A'
        self.classifier_model = None

        self.detection_confidence_threshold = DEFAULT_OUTPUT_THRESHOLD
        self.classification_confidence_threshold = \
            DEFAULT_CLASSIFICATION_THRESHOLD
        self.classifier_batch_size = DEFAULT_CLASSIFIER_BATCH_SIZE
        self.detector_batch_size = 8
        self.top_k_classifications = 3
        self.classifiable_categories = DEFAULT_CLASSIFIABLE_CATEGORIES
        self.crop_expansion = 0.0
        self.square_crops = False

        self.include_videos = True
        self.frame_sample = None
        self.time_sample = None

        self.image_size = None
        self.detector_options = None
        self.classifier_options = None
        self.loader_workers = 4
        # Crop-producer threads feeding the bounded crop queue
        self.crop_workers = 4
        self.crop_queue_depth = 64
        self.verbose = False

        # Ensemble stage (taxonomy rollup + geofencing)
        self.apply_ensemble = False
        self.rollup_confidence_threshold = 0.65
        self.geofence_file = None
        self.taxonomy_file = None
        self.country = None
        self.admin1_region = None

        self.device = None
        self.step_seconds = None


def _qualifying_detections(im, options):
    detections = im.get('detections') or []
    return [
        (i, d) for i, d in enumerate(detections)
        if d['category'] in options.classifiable_categories and
        d['conf'] >= options.classification_confidence_threshold]


def _is_video_result(im):
    return 'frames_processed' in im or 'frame_rate' in im


def _consume_crop_queue(crop_q, n_producers, classifier, options,
                        timings=None):
    """
    Drain (det, crop) pairs from [crop_q] until [n_producers] sentinels
    (None) arrived, classifying in batches of options.classifier_batch_size
    (the tail padded to it). Keeps one batch in flight: batch N + 1 is
    dispatched before batch N's results are fetched. Returns the number of
    classified detections. [timings], a dict, gains the seconds spent
    waiting for crops ('crop') and in the classifier's calls
    ('classify').
    """

    pending = []
    in_flight = None  # (handle, dets) of the dispatched, unfetched batch
    n_classified = 0
    n_sentinels = 0
    waited = spent = 0.0

    def drain_in_flight():
        nonlocal in_flight, n_classified
        if in_flight is None:
            return
        handle, dets = in_flight
        in_flight = None
        probs = classifier.fetch_batch(handle)
        for det, p in zip(dets, probs):
            det['classifications'] = classifier.top_k(
                p, k=options.top_k_classifications)
        n_classified += len(dets)

    def flush():
        nonlocal in_flight, spent
        if not pending:
            return
        start = time.time()
        dets = [p[0] for p in pending]
        crops = [p[1] for p in pending]
        pending.clear()
        # Dispatch the new batch before waiting for the previous one, so
        # the device always has work queued
        handle = classifier.classify_batch_async(
            crops, pad_to=options.classifier_batch_size)
        drain_in_flight()
        in_flight = (handle, dets)
        spent += time.time() - start

    while n_sentinels < n_producers:
        start = time.time()
        item = crop_q.get()
        waited += time.time() - start
        if item is None:
            n_sentinels += 1
            continue
        pending.append(item)
        if len(pending) >= options.classifier_batch_size:
            flush()
    flush()
    start = time.time()
    drain_in_flight()
    spent += time.time() - start
    if timings is not None:
        timings['crop'] = timings.get('crop', 0.0) + waited
        timings['classify'] = timings.get('classify', 0.0) + spent
    return n_classified


class _Turns:
    """Hands out turns in input order: wait(i) returns once every item
    before i has finished (finish)."""

    def __init__(self):
        self.next = 0
        self.finished = set()
        self.cond = threading.Condition()

    def wait(self, i):
        with self.cond:
            while self.next < i:
                self.cond.wait()

    def finish(self, i):
        with self.cond:
            self.finished.add(i)
            while self.next in self.finished:
                self.finished.discard(self.next)
                self.next += 1
            self.cond.notify_all()


def _classify_in_order(work, crops_of, classifier, options, timings):
    """
    Classify the crops of every item of [work] in input order: producer
    threads run crops_of(item) -> [(det, crop), ...] in parallel, and each
    puts its item's crops on the bounded queue only in the item's turn.
    Returns the number of classified detections.
    """

    if not work:
        return 0
    n_workers = max(1, min(options.crop_workers, len(work)))
    crop_q = queue.Queue(maxsize=options.crop_queue_depth)
    turns = _Turns()

    def producer(worker_idx):
        # The sentinel must reach the queue and every turn of this worker
        # must finish even if something raises (a dead producer would
        # hang the consumer or the other producers); per-item failures
        # are contained in crops_of
        mine = range(worker_idx, len(work), n_workers)
        done = set()
        try:
            for i in mine:
                crops = crops_of(work[i])
                turns.wait(i)
                try:
                    for item in crops:
                        crop_q.put(item)
                finally:
                    turns.finish(i)
                    done.add(i)
        finally:
            for i in mine:
                if i not in done:
                    turns.finish(i)
            crop_q.put(None)

    threads = []
    for w in range(n_workers):
        t = threading.Thread(target=producer, args=(w,), daemon=True)
        t.start()
        threads.append(t)

    n_classified = _consume_crop_queue(crop_q, n_workers, classifier,
                                       options, timings)
    for t in threads:
        t.join()
    return n_classified


def _crops(image_np, dets, classifier, options, where):
    """[(det, preprocessed crop)] for [dets] of one image or frame;
    failures are skipped (printed when verbose)."""

    out = []
    for det in dets:
        try:
            crop = extract_crop(image_np, det['bbox'],
                                expansion=options.crop_expansion,
                                square=options.square_crops)
            if crop.size == 0:
                continue
            out.append((det, classifier.preprocess_crop(crop)))
        except Exception as e:
            if options.verbose:
                print('Crop failure in {}: {}'.format(where, e))
    return out


def _classify_detections_for_images(data, image_base, classifier, options,
                                    timings=None):
    """
    Attach classifications to image detections in [data] (in place):
    producer threads decode the images and cut the qualifying crops, the
    main thread runs the classifier batches. Returns the number of
    classified detections.
    """

    work = [im for im in data['images']
            if not _is_video_result(im) and
            _qualifying_detections(im, options)]

    def crops_of(im):
        try:
            image_np = np.asarray(vis_utils.load_image(
                os.path.join(image_base, im['file'])))
        except Exception:
            return []
        return _crops(image_np,
                      [d for _, d in _qualifying_detections(im, options)],
                      classifier, options, im['file'])

    return _classify_in_order(work, crops_of, classifier, options, timings)


def _classify_detections_for_videos(data, video_base, classifier,
                                    options, timings=None):
    """
    Attach classifications to video detections in [data] (in place): per
    video, the frames carrying qualifying detections are decoded again
    and their crops classified, in frame order, then detection order.
    Returns the number of classified detections.
    """

    from megadetector_tpu_torch.detection import video_utils

    work = []
    for im in data['images']:
        if not _is_video_result(im) or im.get('detections') is None:
            continue
        qualifying = _qualifying_detections(im, options)
        if qualifying:
            work.append((im, qualifying))

    def crops_of(item):
        im, qualifying = item
        frame_to_dets = {}
        for _, det in qualifying:
            frame_to_dets.setdefault(
                int(det.get('frame_number', 0)), []).append(det)
        out = []

        def frame_callback(frame_np, frame_id):
            frame_number = video_utils._filename_to_frame_number(frame_id)
            out.extend(_crops(frame_np, frame_to_dets.get(frame_number, []),
                              classifier, options, im['file']))

        try:
            video_utils.run_callback_on_frames(
                os.path.join(video_base, im['file']), frame_callback,
                frames_to_process=sorted(frame_to_dets),
                allow_empty_videos=True)
        except Exception as e:
            if options.verbose:
                print('Video crop failure for {}: {}'.format(
                    im['file'], e))
        return out

    return _classify_in_order(work, crops_of, classifier, options, timings)


def _parse_options(value):
    return ct_utils.parse_kvp_list(value) if isinstance(value, list) \
        else value


def run_md_and_classifier(options):
    """
    Run the two-stage pipeline over options.input_folder, writing MD
    output with classifications to options.output_file. Returns the
    output dict.
    """

    if options.classifier_model is None:
        raise ValueError('A classifier model is required')
    start = time.time()
    detector_options = dict(_parse_options(options.detector_options) or {})

    # --- Detection step: one detector for the images and the videos
    detector = options.detector_model
    if not hasattr(detector, 'preprocess_image'):
        detector_options.setdefault('pad_batches_to',
                                    options.detector_batch_size)
        detector_options.pop('use_mesh', None)
        detector = load_detector(detector, detector_options=detector_options,
                                 device=options.device)
    image_files = path_utils.find_images(options.input_folder,
                                         recursive=True)
    detection_results = []
    if len(image_files) > 0:
        detection_results = \
            run_detector_batch.load_and_run_detector_batch(
                detector, image_files,
                confidence_threshold=options.detection_confidence_threshold,
                batch_size=options.detector_batch_size,
                image_size=options.image_size,
                loader_workers=options.loader_workers,
                quiet=not options.verbose)

    detector_file = options.detector_model if isinstance(
        options.detector_model, str) else None
    data = run_detector_batch.write_results_to_file(
        detection_results, options.output_file,
        relative_path_base=options.input_folder,
        detector_file=detector_file)

    if options.include_videos:
        video_files = path_utils.find_videos(options.input_folder,
                                             recursive=True)
        if len(video_files) > 0:
            video_options = process_video_module.ProcessVideoOptions()
            video_options.model_file = detector
            video_options.input_video_file = options.input_folder
            video_options.output_json_file = \
                options.output_file + '.videos.json'
            video_options.frame_sample = options.frame_sample
            video_options.time_sample = options.time_sample
            video_options.json_confidence_threshold = \
                options.detection_confidence_threshold
            video_options.image_size = options.image_size
            video_options.verbose = options.verbose
            process_video_module.process_videos(video_options)
            with open(video_options.output_json_file) as f:
                video_data = json.load(f)
            data['images'].extend(video_data['images'])
            os.remove(video_options.output_json_file)
    detect_seconds = time.time() - start

    # --- Classification step
    classifier = SpeciesClassifier(
        options.classifier_model,
        classifier_options=_parse_options(options.classifier_options),
        device=options.device)

    timings = {}
    n_classified = _classify_detections_for_images(
        data, options.input_folder, classifier, options, timings)
    n_classified += _classify_detections_for_videos(
        data, options.input_folder, classifier, options, timings)
    print('Classified {} detections'.format(n_classified))

    from megadetector_tpu_torch.postprocessing.classification_ensemble \
        import is_taxonomy_string, parse_taxonomy_string

    # SpeciesNet-style taxonomy-string class names: categories get the
    # common name, the full 7-part strings go into
    # classification_category_descriptions
    names = classifier.class_names
    if any(is_taxonomy_string(n) for n in names):
        categories = {}
        descriptions = {}
        for i, name in enumerate(names):
            if is_taxonomy_string(name):
                parsed = parse_taxonomy_string(name)
                label = parsed['common_name'] or \
                    next((parsed[level] for level in
                          ('species', 'genus', 'family', 'order',
                           'class') if parsed[level]), name)
                categories[str(i)] = label
                descriptions[str(i)] = name
            else:
                categories[str(i)] = name
                descriptions[str(i)] = name
        data['classification_categories'] = categories
        data['classification_category_descriptions'] = descriptions
    else:
        data['classification_categories'] = {
            str(i): name for i, name in enumerate(names)}

    # Optional ensemble: taxonomy rollup + geofencing
    if options.apply_ensemble:
        from megadetector_tpu_torch.postprocessing.classification_ensemble \
            import (EnsembleOptions, apply_classification_ensemble,
                    load_geofence_table)
        e_options = EnsembleOptions()
        e_options.rollup_confidence_threshold = \
            options.rollup_confidence_threshold
        e_options.top_k = options.top_k_classifications
        if options.geofence_file is not None:
            e_options.geofence_table = load_geofence_table(
                options.geofence_file)
        if options.country is not None:
            location = options.country + (
                '/' + options.admin1_region
                if options.admin1_region else '')
            e_options.location_for_image = lambda im: location
        taxonomy = None
        if options.taxonomy_file is not None:
            from megadetector_tpu_torch.taxonomy_mapping.taxonomy_graph \
                import TaxonomyGraph
            taxonomy = TaxonomyGraph.from_file(options.taxonomy_file)
        data = apply_classification_ensemble(data, taxonomy=taxonomy,
                                             options=e_options)

    ct_utils.write_json(options.output_file, data, force_str=True)
    options.step_seconds = {'detect': detect_seconds,
                            'crop': timings.get('crop', 0.0),
                            'classify': timings.get('classify', 0.0),
                            'total': time.time() - start}
    print('Wrote two-stage results to {}'.format(options.output_file))
    return data


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Run the two-stage detect -> classify pipeline')
    parser.add_argument('input_folder')
    parser.add_argument('output_file')
    parser.add_argument('--detector_model', default='MDV5A')
    parser.add_argument('--classifier_model', required=True)
    parser.add_argument('--detection_confidence_threshold', type=float,
                        default=DEFAULT_OUTPUT_THRESHOLD)
    parser.add_argument('--classification_confidence_threshold',
                        type=float,
                        default=DEFAULT_CLASSIFICATION_THRESHOLD)
    parser.add_argument('--classifier_batch_size', type=int,
                        default=DEFAULT_CLASSIFIER_BATCH_SIZE)
    parser.add_argument('--frame_sample', type=int, default=None)
    parser.add_argument('--time_sample', type=float, default=None)
    parser.add_argument('--detector_options', nargs='*', default=None)
    parser.add_argument('--classifier_options', nargs='*', default=None,
                        help='k=v pairs for SpeciesClassifier (e.g. '
                             'quantize=int8 dtype=bfloat16)')
    parser.add_argument('--crop_workers', type=int, default=4)
    parser.add_argument('--apply_ensemble', action='store_true',
                        help='apply taxonomy rollup (+ geofencing when '
                             'a geofence file is given)')
    parser.add_argument('--rollup_confidence_threshold', type=float,
                        default=0.65)
    parser.add_argument('--geofence_file', default=None,
                        help='geofence table (SpeciesNet base format '
                             'or {name: [location prefixes]})')
    parser.add_argument('--taxonomy_file', default=None,
                        help='taxonomy rows (.json or .csv: id, level, '
                             'name, parent_id); needs networkx')
    parser.add_argument('--country', default=None,
                        help='ISO country code for geofencing')
    parser.add_argument('--admin1_region', default=None,
                        help='admin1 region (e.g. US state) for '
                             'geofencing')
    parser.add_argument('--device', default=None,
                        help="'cuda' (default), 'cuda:N' or 'cpu'")

    if argv is None:
        argv = sys.argv[1:]
    if len(argv) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args(argv)
    options = MDAndClassifierOptions()
    ct_utils.args_to_object(args, options)
    run_md_and_classifier(options)


if __name__ == '__main__':
    main()
