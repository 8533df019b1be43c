"""
Repeat detection elimination (RDE): find "that rock looks like an animal"
false positives by clustering near-identical boxes that recur many times
at one location (camera folder), then flag them for human review and flip
their confidences negative.

Behavioral contract follows the reference
(megadetector/postprocessing/repeat_detection_elimination/
repeat_detections_core.py): default thresholds (conf in [0.1, 1.0], IoU
0.9, occurrence >= 20, suspicious size <= 0.2 of the image, :84-100),
per-location candidate clustering with instances allowed to join multiple
clusters (:666-784), a human-review filtering folder of rendered
detections plus a detection index (:1112), and negative-confidence
flipping of confirmed repeats (:815-880). The reference's Rust-backed
quadtree (fastquadtree) is replaced by a uniform grid-hash spatial index
(detections are tiny and near-uniformly distributed; grid cells bound the
IoU candidate set just as well).

The port's own copy of
megadetector_tpu/postprocessing/repeat_detection_elimination/repeat_detections_core.py:
the same public names, signatures, defaults and output bytes. No progress
bars: the card's machine is not promised tqdm. Process pools are spawned,
not forked: the caller may hold a CUDA context and loader threads.
'clustersort' clusters through scipy, not sklearn.
"""

import json
import multiprocessing
import os
import shutil

from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor, ProcessPoolExecutor
from datetime import datetime

from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils.path_utils import is_image_file

DETECTION_INDEX_FILE_NAME = 'detectionIndex.json'


#%% Options


class RepeatDetectionOptions:
    """
    Options controlling find_repeat_detections(); field names match the
    reference so workflow code ports over unchanged.
    """

    def __init__(self):
        self.imageBase = ''
        self.outputBase = ''

        # Only detections in this confidence range are considered
        self.confidenceMin = 0.1
        self.confidenceMax = 1.0
        # Two boxes are "the same detection" above this IoU
        self.iouThreshold = 0.9
        # A candidate becomes suspicious at this many occurrences
        self.occurrenceThreshold = 20
        # Relative-size bounds on suspicious detections
        self.minSuspiciousDetectionSize = 0.0
        self.maxSuspiciousDetectionSize = 0.2

        self.maxImagesPerFolder = None
        self.excludeClasses = []
        self.nWorkers = 10
        self.parallelizationUsesThreads = True

        # Write the human-review folder of rendered detections
        self.bWriteFilteringFolder = True
        self.bParallelizeComparisons = True
        self.bParallelizeRendering = True
        self.categoryAgnosticComparisons = False

        self.maxOutputImageWidth = 2000
        self.lineThickness = 10
        self.boxExpansion = 2

        # How to map images to locations: strip this many levels from the
        # leaf folder, or supply a custom function
        self.nDirLevelsFromLeaf = 0
        self.customDirNameFunction = None
        self.includeFolders = None
        self.excludeFolders = None

        # Previously-generated filtering folder to apply instead of
        # recomputing (after human review)
        self.filterFileToLoad = ''

        self.bRenderOtherDetections = False
        self.otherDetectionsThreshold = 0.2
        # Line width / colors for the "other detections" context boxes
        # (reference: repeat_detections_core.py:233,270)
        self.otherDetectionsLineWidth = 1
        self.otherDetectionsColors = [(105, 105, 105, 100)]

        # Render each sample image as a composite with a grid of every
        # instance's crop beside it (reference:
        # repeat_detections_core.py:237-259). Off by default here
        # (reference default is on): tile mosaics re-open every instance
        # image, which dominates filtering-folder time on large jobs.
        self.bRenderDetectionTiles = False
        self.detectionTilesMaxCrops = 150
        #: None = the (possibly resized) sample image's own width
        self.detectionTilesPrimaryImageWidth = None
        #: <=1.0 = fraction of the primary image width, else pixels
        self.detectionTilesCroppedGridWidth = 0.6
        self.detectionTilesPrimaryImageLocation = 'right'

        # Within-location ordering of rendered candidates so similar
        # detections are adjacent during human review (reference:
        # repeat_detections_core.py:280-283,463-558): None, 'xsort'
        # (by box center x), or 'clustersort' (agglomerative clustering
        # of box centers, clusters ordered by centroid x)
        self.smartSort = 'xsort'
        #: Only relevant if smartSort == 'clustersort'
        self.smartSortDistanceThreshold = 0.1

        # Substring replacements applied to image paths before opening
        # them for rendering (reference: repeat_detections_core.py:199)
        self.filenameReplacements = {}

        # Raise rendering errors instead of warning and continuing
        self.bFailOnRenderError = False

        self.debugMaxDir = -1
        # Accepted for reference API parity; declared but never consumed
        # by the reference either (repeat_detections_core.py:150-156)
        self.debugMaxRenderDir = -1
        self.debugMaxRenderDetection = -1
        self.debugMaxRenderInstance = -1


class RepeatDetectionResults:
    """Results of a repeat-detection analysis."""

    def __init__(self):
        # The loaded results dict (mutated in place)
        self.detection_data = None
        # {location: [candidate dicts]} for suspicious detections
        self.suspicious_detections = {}
        self.filter_file = None
        self.output_file = None


#%% Spatial grid index


class IndexedDetection:
    """
    A single detection event on a single image (reference:
    repeat_detections_core.py:318-350). The dict-based pipeline in this
    module uses {'filename', 'i_detection', 'bbox', 'conf'} instances;
    this is the object view for code written against the reference.
    """

    def __init__(self, i_detection=-1, filename='', bbox=None,
                 confidence=-1, category='unknown'):
        if bbox is None:
            bbox = []
        assert isinstance(i_detection, int)
        assert isinstance(filename, str)
        assert isinstance(bbox, list)
        assert isinstance(category, str)

        #: index of this detection within its image's detections
        self.i_detection = i_detection
        self.filename = filename
        #: [x_min, y_min, width_of_box, height_of_box]
        self.bbox = bbox
        self.confidence = confidence
        #: category ID (not name)
        self.category = category

    @classmethod
    def from_instance_dict(cls, d, category='unknown'):
        return cls(i_detection=d['i_detection'],
                   filename=d['filename'], bbox=list(d['bbox']),
                   confidence=d['conf'], category=category)

    def __repr__(self):
        return 'IndexedDetection({}, {}, conf={})'.format(
            self.filename, self.i_detection, self.confidence)


class DetectionLocation:
    """
    A unique-ish detection location within one directory; detections
    within the IoU threshold of self.bbox accumulate in
    self.instances (reference:
    repeat_detections_core.py:352-412).
    """

    def __init__(self, instance, detection, relative_dir,
                 category=None, id=None):
        assert isinstance(detection, dict)
        assert isinstance(instance, IndexedDetection)
        assert isinstance(relative_dir, str)

        #: IndexedDetections matching this location
        self.instances = [instance]
        #: category ID (not name)
        self.category = category if category is not None \
            else detection.get('category', instance.category)
        #: bbox as x, y, w, h
        self.bbox = detection['bbox']
        #: relative folder (i.e. camera name)
        self.relativeDir = relative_dir
        #: relative path to the canonical sample image
        self.sampleImageRelativeFileName = ''
        self.id = id

    @classmethod
    def from_candidate_dict(cls, candidate):
        """Object view of this module's candidate dicts."""

        instances = [IndexedDetection.from_instance_dict(
            d, category=candidate['category'])
            for d in candidate['instances']]
        loc = cls(instances[0],
                  {'bbox': candidate['bbox'],
                   'category': candidate['category']},
                  candidate.get('relative_dir', ''))
        loc.instances = instances
        return loc

    def to_api_detection(self):
        """
        This location as an MD 'detection' dict, using the
        highest-confidence instance's confidence (reference:
        repeat_detections_core.py:394-420); instances must already be
        sorted confidence-descending.
        """

        confidences = [i.confidence for i in self.instances]
        assert confidences[0] == max(confidences), \
            'Cannot convert an unsorted DetectionLocation to an API ' \
            'detection'
        return {'category': self.category,
                'conf': confidences[0],
                'bbox': self.bbox}

    def __repr__(self):
        return 'DetectionLocation({}, {} instances)'.format(
            self.relativeDir, len(self.instances))


class GridIndex:
    """
    Uniform grid-hash over normalized [0,1] box space. insert() registers a
    box with a payload; query() returns payloads whose cells overlap a box.
    Replaces the reference's Rust quadtree for candidate lookup.
    """

    def __init__(self, cell_size=0.05):
        self.cell_size = cell_size
        self.cells = defaultdict(list)
        self.items = []

    def _cell_range(self, bbox):
        x0 = int(bbox[0] / self.cell_size)
        y0 = int(bbox[1] / self.cell_size)
        x1 = int((bbox[0] + bbox[2]) / self.cell_size)
        y1 = int((bbox[1] + bbox[3]) / self.cell_size)
        return x0, y0, x1, y1

    def insert(self, bbox, payload):
        self.items.append(payload)
        x0, y0, x1, y1 = self._cell_range(bbox)
        for cx in range(x0, x1 + 1):
            for cy in range(y0, y1 + 1):
                self.cells[(cx, cy)].append(payload)

    def query(self, bbox):
        x0, y0, x1, y1 = self._cell_range(bbox)
        seen = set()
        out = []
        for cx in range(x0, x1 + 1):
            for cy in range(y0, y1 + 1):
                for payload in self.cells.get((cx, cy), ()):
                    pid = id(payload)
                    if pid not in seen:
                        seen.add(pid)
                        out.append(payload)
        return out

    def all_items(self):
        return list(self.items)


#%% Location mapping


def image_file_to_location(filename, options):
    """Map an image path to its location identifier (folder)."""

    if options.customDirNameFunction is not None:
        return options.customDirNameFunction(filename)
    location = os.path.dirname(filename.replace('\\', '/'))
    for _ in range(options.nDirLevelsFromLeaf):
        location = os.path.dirname(location)
    return location


#%% Core per-location matching


def _find_matches_in_directory(dir_name, images, options):
    """
    Cluster near-identical detections within one location.

    Args:
        dir_name: location identifier
        images: list of image dicts (MD format) at this location
        options: RepeatDetectionOptions

    Returns:
        list of candidate dicts:
        {'bbox', 'category', 'relative_dir', 'instances': [
            {'filename', 'i_detection', 'bbox', 'conf'}]}
    """

    if options.maxImagesPerFolder is not None and \
            len(images) > options.maxImagesPerFolder:
        return []
    if options.includeFolders is not None and \
            dir_name not in options.includeFolders:
        return []
    if options.excludeFolders is not None and \
            dir_name in options.excludeFolders:
        return []

    index = GridIndex(cell_size=max(
        options.maxSuspiciousDetectionSize, 0.05))

    for im in images:
        filename = im['file']
        if not is_image_file(filename):
            continue
        detections = im.get('detections')
        if detections is None:
            continue

        for i_detection, detection in enumerate(detections):
            conf = detection['conf']
            if conf < options.confidenceMin or conf > options.confidenceMax:
                continue
            if options.excludeClasses and \
                    int(detection['category']) in options.excludeClasses:
                continue
            bbox = detection['bbox']
            w, h = bbox[2], bbox[3]
            if w <= 0 or h <= 0:
                continue
            size = w * h
            if size > options.maxSuspiciousDetectionSize or \
                    size < options.minSuspiciousDetectionSize:
                continue

            instance = {'filename': filename,
                        'i_detection': i_detection,
                        'bbox': list(bbox),
                        'conf': conf}
            category = detection['category']

            found = False
            for candidate in index.query(bbox):
                if not options.categoryAgnosticComparisons and \
                        candidate['category'] != category:
                    continue
                try:
                    iou = ct_utils.get_iou(bbox, candidate['bbox'])
                except AssertionError:
                    continue
                if iou >= options.iouThreshold:
                    found = True
                    # An instance may join multiple candidates, matching
                    # the reference's no-break behavior
                    candidate['instances'].append(instance)
            if not found:
                candidate = {'bbox': list(bbox),
                             'category': category,
                             'relative_dir': dir_name,
                             'instances': [instance]}
                index.insert(bbox, candidate)

    return _sort_candidates_for_directory(index.all_items(), options)


def _sort_candidates_for_directory(candidates, options):
    """
    Order one location's candidates so spatially-nearby boxes render
    adjacently in the filtering folder, making human review faster
    (reference: repeat_detections_core.py:463-558). 'xsort' orders by
    box-center x; 'clustersort' clusters box centers (complete-linkage
    agglomerative through scipy, merging below
    options.smartSortDistanceThreshold) and orders clusters by centroid x.
    Returns a sorted copy.
    """

    if len(candidates) <= 1 or not getattr(options, 'smartSort', None):
        return candidates

    if options.smartSort == 'xsort':
        return sorted(candidates,
                      key=lambda c: c['bbox'][0] + c['bbox'][2] / 2.0)

    if options.smartSort == 'clustersort':
        import numpy as np
        from scipy.cluster.hierarchy import fcluster, linkage
        points = np.array([[c['bbox'][0] + c['bbox'][2] / 2.0,
                            c['bbox'][1] + c['bbox'][3] / 2.0]
                           for c in candidates])
        # Complete-linkage agglomerative clusters that merge only below the
        # distance threshold (sklearn's AgglomerativeClustering with
        # distance_threshold): fcluster also merges at the threshold, so
        # it cuts just below it
        labels = fcluster(
            linkage(points, method='complete'),
            t=np.nextafter(options.smartSortDistanceThreshold, 0),
            criterion='distance')
        # Order clusters by their centroid x so the sort key is spatial
        # (ties: the cluster holding the earlier candidate first)
        label_to_key = {}
        for label in np.unique(labels):
            members = np.flatnonzero(labels == label)
            label_to_key[int(label)] = (float(points[members, 0].mean()),
                                        int(members[0]))
        order = {label: rank for rank, label in enumerate(
            sorted(label_to_key, key=label_to_key.get))}
        return [c for _, _, c in sorted(
            ((order[int(labels[i])], i, c)
             for i, c in enumerate(candidates)),
            key=lambda t: (t[0], t[1]))]

    raise ValueError('Unrecognized sort method {}'.format(
        options.smartSort))


def _find_matches_job(args):
    """Picklable process-pool wrapper around _find_matches_in_directory."""

    dir_name, images, options_state = args
    options = RepeatDetectionOptions()
    options.__dict__.update(options_state)
    return _find_matches_in_directory(dir_name, images, options)


#%% Main analysis


def find_repeat_detections(input_filename, output_filename=None,
                           options=None):
    """
    Run the repeat-detection analysis over an MD results file.

    When options.filterFileToLoad is empty: compute suspicious detections,
    optionally write the human-review filtering folder
    (options.outputBase), and write [output_filename] with repeats'
    confidences flipped negative.

    When options.filterFileToLoad points to a detectionIndex.json from a
    (possibly human-edited) filtering folder: apply that filter instead of
    recomputing.

    Returns a RepeatDetectionResults.
    """

    if options is None:
        options = RepeatDetectionOptions()

    to_return = RepeatDetectionResults()
    to_return.output_file = output_filename

    with open(input_filename) as f:
        data = json.load(f)
    to_return.detection_data = data

    if options.filterFileToLoad:
        # Apply a previously-computed (human-reviewed) filter
        suspicious = _load_filter_file(options.filterFileToLoad)
        to_return.filter_file = options.filterFileToLoad
    else:
        # Group images by location
        location_to_images = defaultdict(list)
        for im in data['images']:
            location = image_file_to_location(im['file'], options)
            location_to_images[location].append(im)

        locations = sorted(location_to_images.keys())
        if options.debugMaxDir > 0:
            locations = locations[:options.debugMaxDir]

        print('Finding repeat detections in {} locations'.format(
            len(locations)))

        def _one(location):
            return _find_matches_in_directory(
                location, location_to_images[location], options)

        if options.bParallelizeComparisons and options.nWorkers > 1 and \
                len(locations) > 1:
            if options.parallelizationUsesThreads:
                # NB: the per-location loop is pure Python (grid query +
                # IoU), so threads serialize on the GIL; they still
                # match the reference's default and avoid pickling the
                # per-location image lists. Set
                # parallelizationUsesThreads=False for real parallelism
                # on large jobs.
                with ThreadPoolExecutor(
                        max_workers=options.nWorkers) as pool:
                    all_candidates = list(pool.map(_one, locations))
            else:
                # Process pool: ships (location, images, options state)
                # to module-level workers. customDirNameFunction may be
                # unpicklable, but it's only used for location grouping,
                # which already happened above.
                options_state = {
                    k: v for k, v in vars(options).items()
                    if k != 'customDirNameFunction'}
                jobs = [(loc, location_to_images[loc], options_state)
                        for loc in locations]
                # Spawned, not forked: the caller may hold a CUDA
                # context and loader threads
                with ProcessPoolExecutor(
                        max_workers=options.nWorkers,
                        mp_context=multiprocessing.get_context(
                            'spawn')) as pool:
                    all_candidates = list(
                        pool.map(_find_matches_job, jobs))
        else:
            all_candidates = [_one(loc) for loc in locations]

        # Flag suspicious candidates
        suspicious = []
        for candidates in all_candidates:
            for candidate in candidates:
                # Count UNIQUE files: a burst can put several instances
                # in one frame; a repeat is a box recurring across many
                # distinct files
                n = len({inst['filename']
                         for inst in candidate['instances']})
                if n >= options.occurrenceThreshold:
                    suspicious.append(candidate)

        print('Found {} suspicious detection groups'.format(
            len(suspicious)))

        if options.bWriteFilteringFolder and options.outputBase:
            to_return.filter_file = _write_filtering_folder(
                suspicious, data, options)

    # Group by location for reporting
    by_location = defaultdict(list)
    for s in suspicious:
        by_location[s['relative_dir']].append(s)
    to_return.suspicious_detections = dict(by_location)

    # Flip confidences and write output
    n_changes = _update_detection_table(data, suspicious)
    print('Flipped {} detection confidences'.format(n_changes))

    if output_filename is not None:
        ct_utils.write_json(output_filename, data, force_str=True)

    return to_return


def _update_detection_table(data, suspicious_detections):
    """Make confirmed repeats' confidences negative (in place)."""

    fn_to_image = {im['file']: im for im in data['images']}
    n_changes = 0
    for candidate in suspicious_detections:
        for instance in candidate['instances']:
            im = fn_to_image.get(instance['filename'])
            if im is None or im.get('detections') is None:
                continue
            det = im['detections'][instance['i_detection']]
            assert det['bbox'][0:4] == instance['bbox'][0:4], \
                'Detection index mismatch for {}'.format(
                    instance['filename'])
            if det['conf'] >= 0:
                det['conf'] = -1 * det['conf']
                n_changes += 1
    return n_changes


#%% Filtering folder (human review)


def _render_candidate(i_candidate, candidate, data, options,
                      filename_to_image=None):
    """Render one suspicious detection to the filtering folder."""

    from megadetector_tpu_torch.visualization import visualization_utils as \
        vis_utils

    def _resolve(filename):
        # reference: repeat_detections_core.py:1197-1199
        for s, r in (options.filenameReplacements or {}).items():
            filename = filename.replace(s, r)
        return os.path.join(options.imageBase, filename)

    instance = candidate['instances'][0]
    source = _resolve(instance['filename'])
    rendered_name = 'detection_{:0>4d}.jpg'.format(i_candidate)
    target = os.path.join(options.outputBase, rendered_name)

    try:
        image = vis_utils.load_image(source)
        detection = {'category': candidate['category'],
                     'conf': abs(instance['conf']),
                     'bbox': candidate['bbox']}
        if options.bRenderOtherDetections and filename_to_image:
            # Context for the reviewer: the image's OTHER detections, in
            # gray with no labels, so the suspicious box stands out
            im_record = filename_to_image.get(instance['filename'])
            others = [d for d in (im_record or {}).get('detections') or []
                      if abs(d.get('conf', 0)) >=
                      options.otherDetectionsThreshold and
                      d.get('bbox') != instance['bbox']]
            if others:
                vis_utils.render_detection_bounding_boxes(
                    [{'category': d['category'],
                      'conf': abs(d['conf']),
                      'bbox': d['bbox']} for d in others], image,
                    label_map=None,
                    confidence_threshold=0.0,
                    thickness=options.otherDetectionsLineWidth,
                    expansion=options.boxExpansion,
                    colormap=list(options.otherDetectionsColors))
        vis_utils.render_detection_bounding_boxes(
            [detection], image,
            confidence_threshold=0.0,
            thickness=options.lineThickness,
            expansion=options.boxExpansion)
        if options.maxOutputImageWidth is not None and \
                image.size[0] > options.maxOutputImageWidth:
            image = vis_utils.resize_image(
                image, target_width=options.maxOutputImageWidth)
        image.save(target)

        if options.bRenderDetectionTiles:
            # Overwrite the sample image with a composite that shows
            # every instance's crop beside it (reference:
            # repeat_detections_core.py:1053-1095)
            from megadetector_tpu_torch.visualization \
                .render_images_with_thumbnails import \
                render_images_with_thumbnails
            primary_width = options.detectionTilesPrimaryImageWidth \
                if options.detectionTilesPrimaryImageWidth is not None \
                else image.size[0]
            grid_width = options.detectionTilesCroppedGridWidth
            if grid_width <= 1.0:
                grid_width = round(grid_width * primary_width)
            instances = candidate['instances']
            if options.detectionTilesMaxCrops is not None:
                instances = instances[:options.detectionTilesMaxCrops]
            render_images_with_thumbnails(
                primary_image_filename=target,
                primary_image_width=primary_width,
                secondary_image_filename_list=[
                    _resolve(inst['filename']) for inst in instances],
                secondary_image_bounding_box_list=[
                    inst['bbox'] for inst in instances],
                cropped_grid_width=grid_width,
                output_image_filename=target,
                primary_image_location=(
                    options.detectionTilesPrimaryImageLocation))

        return rendered_name
    except Exception as e:
        if options.bFailOnRenderError:
            raise
        print('Warning: rendering error for {}: {}'.format(source, e))
        return None


def _write_filtering_folder(suspicious_detections, data, options):
    """
    Write rendered suspicious detections + detectionIndex.json to
    options.outputBase. A human then DELETES renderings that show real
    animals; remove_repeat_detections applies what remains.
    """

    folder = os.path.join(
        options.outputBase,
        'filtering_{}'.format(datetime.now().strftime('%Y.%m.%d.%H.%M.%S')))
    os.makedirs(folder, exist_ok=True)

    import copy as _copy
    render_options = _copy.copy(options)
    render_options.outputBase = folder

    entries = []

    filename_to_image = None
    if options.bRenderOtherDetections:
        filename_to_image = {im['file']: im for im in data['images']}

    def _render(args):
        i_candidate, candidate = args
        rendered = _render_candidate(i_candidate, candidate, data,
                                     render_options,
                                     filename_to_image=filename_to_image)
        return i_candidate, rendered

    jobs = list(enumerate(suspicious_detections))
    if options.bParallelizeRendering and options.nWorkers > 1:
        with ThreadPoolExecutor(max_workers=options.nWorkers) as pool:
            rendered_list = list(pool.map(_render, jobs))
    else:
        rendered_list = [_render(j) for j in jobs]

    rendered_by_idx = dict(rendered_list)
    for i_candidate, candidate in enumerate(suspicious_detections):
        entry = dict(candidate)
        entry['rendered_file'] = rendered_by_idx.get(i_candidate)
        entries.append(entry)

    filter_file = os.path.join(folder, DETECTION_INDEX_FILE_NAME)
    ct_utils.write_json(filter_file, {'suspicious_detections': entries})
    print('Wrote filtering folder to {}'.format(folder))
    return filter_file


def _load_filter_file(filter_file, require_rendered_file_exists=True):
    """
    Load a detectionIndex.json; candidates whose rendered file was deleted
    by the human reviewer are dropped (those were real animals).
    """

    with open(filter_file) as f:
        index = json.load(f)
    folder = os.path.dirname(filter_file)

    kept = []
    for entry in index['suspicious_detections']:
        rendered = entry.get('rendered_file')
        if require_rendered_file_exists:
            if rendered is None:
                # Rendering failed, so no human ever reviewed this
                # candidate — never suppress unreviewed detections
                continue
            if not os.path.isfile(os.path.join(folder, rendered)):
                continue
        kept.append(entry)
    print('Filter file: keeping {} of {} suspicious detections'.format(
        len(kept), len(index['suspicious_detections'])))
    return kept
