"""
Compare detection results across models: categorize per-image agreement
(common detections, common non-detections, A-only, B-only, class
transitions), render side-by-side sample pages, and support N-way
comparison as all pairwise comparisons.

Behavioral contract follows the reference
(megadetector/postprocessing/compare_batch_results.py:124,626,1627,1700):
per-pair confidence thresholds (optionally per category), IoU-based
detection matching, sampled HTML galleries per agreement category, and
find_equivalent_threshold for cross-model threshold calibration (:1827).

The port's own copy of
megadetector_tpu/postprocessing/compare_batch_results.py: the same public
names, signatures, defaults and output bytes. Process pools are spawned,
not forked: the caller may hold a CUDA context and loader threads.
"""

import argparse
import collections
import json
import os
import random
import sys

from megadetector_tpu_torch.utils import ct_utils


class PairwiseBatchComparisonResults:
    """Results of one pairwise comparison."""

    def __init__(self):
        self.categories_to_image_files = {}
        self.filename_a = None
        self.filename_b = None
        #: filename -> sort confidence (used by sort_by_confidence)
        self.file_to_sort_conf = {}
        #: The (possibly-derived) options used for this comparison
        self.pairwise_options = None
        #: Short identifier for this comparison (reference:
        #: compare_batch_results.py:264-268)
        self.comparison_short_name = None
        self.comparison_friendly_name = None


class PairwiseBatchComparisonOptions:
    """
    Options for a single pairwise comparison; a list of these can be
    stored in BatchComparisonOptions.pairwise_options (reference:
    compare_batch_results.py:77-121).
    """

    def __init__(self):
        self.results_filename_a = None
        self.results_filename_b = None
        self.results_description_a = None
        self.results_description_b = None
        #: float or {category_name: float, ..., 'default': float}
        self.detection_thresholds_a = {'animal': 0.15, 'person': 0.15,
                                       'vehicle': 0.15, 'default': 0.15}
        self.detection_thresholds_b = {'animal': 0.15, 'person': 0.15,
                                       'vehicle': 0.15, 'default': 0.15}
        self.rendering_confidence_threshold_a = 0.1
        self.rendering_confidence_threshold_b = 0.1
        self.classification_confidence_threshold_a = 0.3
        self.classification_confidence_threshold_b = 0.3


class BatchComparisonResults:
    """
    The results from a set of pairwise comparisons (reference:
    compare_batch_results.py:273-286).
    """

    def __init__(self):
        #: Filename containing HTML output
        self.html_output_file = None
        #: A list of PairwiseBatchComparisonResults
        self.pairwise_results = None


class BatchComparisonOptions:
    """
    Options controlling compare_batch_results().

    Two usage shapes are supported, matching the reference
    (compare_batch_results.py:124): set the flat results_filename_a/b
    fields for a single comparison, or populate .pairwise_options with
    a list of PairwiseBatchComparisonOptions to run several comparisons
    into one output tree.
    """

    def __init__(self):
        self.output_folder = None
        self.image_folder = None
        self.job_name = 'comparison'

        #: Optional list of PairwiseBatchComparisonOptions; when set,
        #: compare_batch_results() runs every pair and returns a
        #: BatchComparisonResults
        self.pairwise_options = None

        self.results_filename_a = None
        self.results_filename_b = None
        self.results_description_a = None
        self.results_description_b = None

        # Thresholds: float or {category_name: float}
        self.detection_thresholds_a = 0.15
        self.detection_thresholds_b = 0.15
        self.rendering_confidence_threshold_a = 0.1
        self.rendering_confidence_threshold_b = 0.1
        self.classification_confidence_threshold_a = 0.3
        self.classification_confidence_threshold_b = 0.3

        self.iou_threshold = 0.5
        self.max_images_per_category = 100
        #: Paginate category pages beyond this many images (None = one
        #: page per category; reference :146-148)
        self.max_images_per_page = None
        self.random_seed = 0
        self.parallelize_rendering = False
        self.parallelize_rendering_n_cores = 8
        #: Threads (True) or processes (False) for the rendering pool
        self.parallelize_rendering_with_threads = True
        self.error_on_non_matching_lists = True

        # Side-by-side gallery rendering (reference:
        # compare_batch_results.py:626-1627): each sampled image renders
        # twice — model A's boxes and model B's boxes — shown as one
        # row. False falls back to unrendered source-image galleries.
        self.render_images = True
        self.viz_target_width = 700
        self.line_thickness = 4
        self.box_expansion = 0
        #: Box colors for each model's panel (lists cycle per category;
        #: reference :149-154)
        self.colormap_a = ['Red']
        self.colormap_b = ['RoyalBlue']
        #: Show category names (vs bare ids) on detected boxes
        self.show_category_names_on_detected_boxes = True
        #: Render classification labels when present
        self.show_classification_categories = True

        #: Only compare these filenames (list/set), or None for all
        self.filenames_to_include = None
        #: Only treat these category NAMES as above-threshold, or None
        self.category_names_to_include = None
        #: Compare detections/non-detections only; category differences
        #: no longer produce class_transitions
        self.class_agnostic_comparison = False
        #: Sort gallery pages by per-image max confidence (vs filename)
        self.sort_by_confidence = False
        #: Only compare filenames containing this token (str), or a
        #: callable filename -> bool
        self.required_token = None

        #: COCO Camera Traps ground truth (.json path or loaded dict).
        #: With GT, agreement categories become TP/TN/FP/FN-based
        #: (common_tp, tp_a_only, fpfn, ...) instead of A-vs-B
        #: (reference :181-199,918-1010)
        self.ground_truth_file = None
        #: IoU for detection-vs-GT-box matching (box-level GT)
        self.gt_iou_threshold = 0.5
        #: GT category names meaning 'empty image' (image-level GT)
        self.gt_empty_categories = ['empty', 'blank', 'misfire']
        #: Show GT category names as text when GT has no boxes
        self.show_labels_for_image_level_gt = True
        #: Show GT category names (vs ids) on GT boxes
        self.show_category_names_on_gt_boxes = True

        self.verbose = False


def _above_threshold_detections(im, thresholds, categories):
    """Detections above the (possibly per-category) threshold."""

    out = []
    for d in im.get('detections') or []:
        if isinstance(thresholds, dict):
            name = categories.get(d['category'], d['category'])
            t = thresholds.get(name, thresholds.get('default', 0.15))
        else:
            t = thresholds
        if d['conf'] >= t:
            out.append(d)
    return out


def _detections_match(dets_a, dets_b, iou_threshold,
                      categories_a, categories_b,
                      class_agnostic=False):
    """
    True when every detection in each list has a same-category match in
    the other at IoU >= threshold. Categories are compared by NAME
    through each model's own category map, so two models that both
    found an 'animal' match even when their numeric category IDs differ
    (e.g. a remapped or non-MD results file). With [class_agnostic],
    categories are ignored entirely.
    """

    def one_way(src, src_cats, dst, dst_cats):
        for d in src:
            matched = False
            d_name = src_cats.get(d['category'], d['category'])
            for e in dst:
                if not class_agnostic and d_name != \
                        dst_cats.get(e['category'], e['category']):
                    continue
                try:
                    if ct_utils.get_iou(d['bbox'], e['bbox']) >= \
                            iou_threshold:
                        matched = True
                        break
                except AssertionError:
                    continue
            if not matched:
                return False
        return True

    return one_way(dets_a, categories_a, dets_b, categories_b) and \
        one_way(dets_b, categories_b, dets_a, categories_a)


def _load_ground_truth(options):
    """Load and index the GT file (str or dict): returns None or a dict
    with per-filename annotations (normalized bboxes attached), the GT
    category map, and whether boxes are present (reference:
    compare_batch_results.py:794-906)."""

    if options.ground_truth_file is None:
        return None
    if isinstance(options.ground_truth_file, dict):
        gt_data = options.ground_truth_file
    else:
        with open(options.ground_truth_file) as f:
            gt_data = json.load(f)

    found_box = any('bbox' in ann
                    for ann in gt_data.get('annotations', []))
    gt_categories = {c['id']: c['name']
                     for c in gt_data.get('categories', [])}
    image_by_id = {im['id']: im for im in gt_data.get('images', [])}
    annotations_by_file = collections.defaultdict(list)
    for ann in gt_data.get('annotations', []):
        im_gt = image_by_id.get(ann['image_id'])
        if im_gt is None:
            continue
        ann = dict(ann)
        if 'bbox' in ann and im_gt.get('width') and im_gt.get('height'):
            x, y, w, h = ann['bbox']
            ann['normalized_bbox'] = [x / im_gt['width'],
                                      y / im_gt['height'],
                                      w / im_gt['width'],
                                      h / im_gt['height']]
        annotations_by_file[im_gt.get('file_name', im_gt['id'])] \
            .append(ann)
    return {
        'type': 'bbox_gt' if found_box else 'image_level_gt',
        'categories': gt_categories,
        'files': set(im.get('file_name', im['id'])
                     for im in gt_data.get('images', [])),
        'annotations_by_file': dict(annotations_by_file),
    }


def _categorize_vs_box_gt(dets, annotations, det_categories,
                          gt_categories, options):
    """Result types (tp/tn/fp/fn) for one model's above-threshold
    detections against box-level GT (reference:
    compare_batch_results.py:1157-1221)."""

    annotations = [a for a in annotations if 'normalized_bbox' in a]

    def boxes_match(det, ann):
        if not options.class_agnostic_comparison:
            det_name = det_categories.get(det['category'],
                                          det['category'])
            gt_name = gt_categories.get(ann['category_id'],
                                        ann['category_id'])
            if det_name != gt_name:
                return False
        try:
            return ct_utils.get_iou(det['bbox'],
                                    ann['normalized_bbox']) >= \
                options.gt_iou_threshold
        except AssertionError:
            return False

    present = set()
    if not dets and not annotations:
        return {'tn'}
    for det in dets:
        present.add('tp' if any(boxes_match(det, a)
                                for a in annotations) else 'fp')
    for ann in annotations:
        if not any(boxes_match(det, ann) for det in dets):
            present.add('fn')
    return present


def _categorize_vs_image_gt(dets, annotations, det_categories,
                            gt_categories, options):
    """Result types for image-level GT: detected category names vs
    annotated category names; gt_empty_categories mean 'empty image'
    (reference: compare_batch_results.py:1260-1318)."""

    detected_names = set(det_categories.get(d['category'], d['category'])
                         for d in dets)
    gt_names = set(gt_categories.get(a['category_id'], a['category_id'])
                   for a in annotations)
    empty = set(options.gt_empty_categories or [])

    present = set()
    if options.class_agnostic_comparison:
        gt_positive = bool(gt_names - empty)
        if gt_positive and detected_names:
            present.add('tp')
        elif gt_positive:
            present.add('fn')
        elif detected_names:
            present.add('fp')
        else:
            present.add('tn')
        return present

    for name in detected_names:
        present.add('tp' if name in gt_names else 'fp')
    if not gt_names and not detected_names:
        present.add('tn')
    for name in gt_names:
        if name in empty:
            if detected_names:
                present.add('fp')
            else:
                present.add('tn')
        elif name not in detected_names:
            present.add('fn')
    return present


def _result_types_to_comparison_category(types_a, types_b):
    """Map the (tp/tn/fp/fn) sets for models A and B to an agreement
    page key (reference: compare_batch_results.py:458-543)."""

    if types_a == {'tp'} and types_b == {'tp'}:
        return 'common_tp'
    if types_a == {'tn'} and types_b == {'tn'}:
        return 'common_tn'
    if 'fp' in types_a and 'fp' in types_b and \
            'fn' not in types_a and 'fn' not in types_b:
        return 'common_fp'
    if 'fn' in types_a and 'fn' in types_b and \
            'fp' not in types_a and 'fp' not in types_b:
        return 'common_fn'
    if types_a == {'tp'} and ('fn' in types_b or 'fp' in types_b):
        return 'tp_a_only'
    if types_b == {'tp'} and ('fn' in types_a or 'fp' in types_a):
        return 'tp_b_only'
    if types_a == {'tn'} and types_b != {'tn'}:
        return 'tn_a_only'
    if types_b == {'tn'} and types_a != {'tn'}:
        return 'tn_b_only'
    return 'fpfn'


def _filename_filter(options):
    """Predicate combining filenames_to_include and required_token."""

    include = None
    if options.filenames_to_include is not None:
        include = set(options.filenames_to_include)
    token = options.required_token

    def keep(fn):
        if include is not None and fn not in include:
            return False
        if token is not None:
            if callable(token):
                return bool(token(fn))
            return token in fn
        return True
    return keep


def _pairwise_compare_batch_results(options, results_a, results_b,
                                    gt=None):
    """Categorize agreement for one pair of loaded results dicts,
    optionally against ground truth."""

    categories_a = results_a.get('detection_categories', {})
    categories_b = results_b.get('detection_categories', {})

    images_a = {im['file']: im for im in results_a['images']}
    images_b = {im['file']: im for im in results_b['images']}

    common_files = sorted(set(images_a.keys()) & set(images_b.keys()))
    if options.error_on_non_matching_lists:
        only_a = set(images_a) - set(images_b)
        only_b = set(images_b) - set(images_a)
        if only_a or only_b:
            raise ValueError(
                'Image lists differ: {} only in A, {} only in B'.format(
                    len(only_a), len(only_b)))
        if gt is not None and set(common_files) - gt['files']:
            raise ValueError(
                'GT image set is not identical to the results image '
                'sets ({} result files missing from GT)'.format(
                    len(set(common_files) - gt['files'])))

    keep = _filename_filter(options)
    common_files = [fn for fn in common_files if keep(fn)]
    if gt is not None:
        common_files = [fn for fn in common_files if fn in gt['files']]

    include_names = None
    if options.category_names_to_include is not None:
        include_names = set(options.category_names_to_include)

    def restricted(dets, categories):
        if include_names is None:
            return dets
        return [d for d in dets
                if categories.get(d['category'], d['category'])
                in include_names]

    categories_to_image_files = collections.defaultdict(list)
    file_to_sort_conf = {}

    for fn in common_files:
        im_a = images_a[fn]
        im_b = images_b[fn]
        if im_a.get('detections') is None or \
                im_b.get('detections') is None:
            categories_to_image_files['failures'].append(fn)
            file_to_sort_conf[fn] = 0.0
            continue
        dets_a = restricted(_above_threshold_detections(
            im_a, options.detection_thresholds_a, categories_a),
            categories_a)
        dets_b = restricted(_above_threshold_detections(
            im_b, options.detection_thresholds_b, categories_b),
            categories_b)

        max_conf_a = max((d['conf'] for d in im_a['detections']),
                         default=0.0)
        max_conf_b = max((d['conf'] for d in im_b['detections']),
                         default=0.0)

        if gt is not None:
            annotations = gt['annotations_by_file'].get(fn, [])
            categorize = _categorize_vs_box_gt \
                if gt['type'] == 'bbox_gt' else _categorize_vs_image_gt
            types_a = categorize(dets_a, annotations, categories_a,
                                 gt['categories'], options)
            types_b = categorize(dets_b, annotations, categories_b,
                                 gt['categories'], options)
            key = _result_types_to_comparison_category(types_a, types_b)
            file_to_sort_conf[fn] = max(max_conf_a, max_conf_b)
            categories_to_image_files[key].append(fn)
            continue

        a_positive = len(dets_a) > 0
        b_positive = len(dets_b) > 0

        if not a_positive and not b_positive:
            key = 'common_non_detections'
            sort_conf = max(max_conf_a, max_conf_b)
        elif a_positive and not b_positive:
            key = 'detections_a_only'
            sort_conf = max_conf_a
        elif b_positive and not a_positive:
            key = 'detections_b_only'
            sort_conf = max_conf_b
        else:
            sort_conf = max(max_conf_a, max_conf_b)
            # Compare category NAMES through each model's own map, so
            # differing numeric IDs across models don't spuriously land
            # every agreement in class_transitions
            cats_a = set(categories_a.get(d['category'], d['category'])
                         for d in dets_a)
            cats_b = set(categories_b.get(d['category'], d['category'])
                         for d in dets_b)
            if cats_a != cats_b and \
                    not options.class_agnostic_comparison:
                key = 'class_transitions'
            elif _detections_match(dets_a, dets_b,
                                   options.iou_threshold,
                                   categories_a, categories_b,
                                   options.class_agnostic_comparison):
                key = 'common_detections'
            else:
                key = 'common_detections_differing_boxes'
        file_to_sort_conf[fn] = sort_conf
        categories_to_image_files[key].append(fn)

    results = PairwiseBatchComparisonResults()
    results.categories_to_image_files = dict(categories_to_image_files)
    results.filename_a = options.results_filename_a
    results.filename_b = options.results_filename_b
    results.file_to_sort_conf = file_to_sort_conf
    return results


def _render_pair_image(job):
    """
    Render one sampled image twice — model A's boxes and model B's —
    into the comparison output folder; GT boxes (when provided) overlay
    both panels in yellow. Returns (target_a, target_b) or None on
    failure (the page falls back to the unrendered source).
    """

    (source, im_a, im_b, categories_a, categories_b,
     classification_categories_a, classification_categories_b,
     target_a, target_b, options, gt_annotations, gt_categories) = job

    from megadetector_tpu_torch.visualization import \
        visualization_utils as vis_utils

    try:
        base = vis_utils.load_image(source)
    except Exception as e:
        print('Warning: comparison rendering error for {}: {}'.format(
            source, e))
        return None
    for im, categories, thresh, cls_thresh, target, colormap, \
            cls_categories in (
            (im_a, categories_a,
             options.rendering_confidence_threshold_a,
             getattr(options, 'classification_confidence_threshold_a',
                     0.3), target_a,
             options.colormap_a, classification_categories_a),
            (im_b, categories_b,
             options.rendering_confidence_threshold_b,
             getattr(options, 'classification_confidence_threshold_b',
                     0.3), target_b,
             options.colormap_b, classification_categories_b)):
        image = base.copy()
        vis_utils.render_detection_bounding_boxes(
            im.get('detections') or [], image,
            label_map=categories
            if options.show_category_names_on_detected_boxes else None,
            classification_label_map=cls_categories
            if options.show_classification_categories else None,
            confidence_threshold=thresh,
            classification_confidence_threshold=cls_thresh,
            thickness=options.line_thickness,
            expansion=options.box_expansion,
            colormap=colormap or vis_utils.DEFAULT_COLORS)
        if gt_annotations:
            gt_boxes = [a['normalized_bbox'] for a in gt_annotations
                        if 'normalized_bbox' in a]
            gt_classes = [a['category_id'] for a in gt_annotations
                          if 'normalized_bbox' in a]
            if gt_boxes:
                vis_utils.render_db_bounding_boxes(
                    gt_boxes, gt_classes, image,
                    label_map=gt_categories
                    if options.show_category_names_on_gt_boxes else None,
                    thickness=options.line_thickness,
                    colormap=['Yellow'],
                    boxes_are_normalized=True)
        if options.viz_target_width is not None and \
                image.size[0] > options.viz_target_width:
            image = vis_utils.resize_image(
                image, target_width=options.viz_target_width)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        image.convert('RGB').save(target, quality=85)
    return (target_a, target_b)


def _detection_summary(im, thresh):
    dets = [d for d in im.get('detections') or [] if d['conf'] >= thresh]
    max_conf = max([d['conf'] for d in im.get('detections') or []],
                   default=0.0)
    return '{} detections, max conf {:.3f}'.format(len(dets), max_conf)


def _apply_pairwise_options(options, pairwise_options):
    """
    Flatten one PairwiseBatchComparisonOptions onto a copy of the shared
    BatchComparisonOptions, producing the flat shape the single-pair
    machinery consumes.
    """

    import copy
    flat = copy.copy(options)
    flat.pairwise_options = None
    for field in ('results_filename_a', 'results_filename_b',
                  'results_description_a', 'results_description_b',
                  'detection_thresholds_a', 'detection_thresholds_b',
                  'rendering_confidence_threshold_a',
                  'rendering_confidence_threshold_b',
                  'classification_confidence_threshold_a',
                  'classification_confidence_threshold_b'):
        setattr(flat, field, getattr(pairwise_options, field))
    return flat


def compare_batch_results(options):
    """
    Full pairwise comparison with HTML output: per-agreement-category
    pages showing each sampled image side by side with model A's and
    model B's boxes rendered (reference:
    compare_batch_results.py:626-1627).

    When options.pairwise_options is populated (the reference's
    multi-comparison shape, compare_batch_results.py:1627-1697), runs
    every pairwise comparison into pair_NN subfolders, writes a
    top-level index, and returns a BatchComparisonResults. Otherwise
    runs the single comparison described by the flat fields and returns
    its PairwiseBatchComparisonResults (with .html_output_file set when
    an output folder was provided).
    """

    if getattr(options, 'pairwise_options', None) is not None:
        pairwise_options_list = options.pairwise_options
        if not isinstance(pairwise_options_list, list):
            pairwise_options_list = [pairwise_options_list]

        all_pairwise_results = []
        index_lines = []
        for i_comparison, pairwise_options in \
                enumerate(pairwise_options_list):
            flat = _apply_pairwise_options(options, pairwise_options)
            short_name = 'pair_{:0>2d}'.format(i_comparison)
            if options.output_folder is not None:
                flat.output_folder = os.path.join(options.output_folder,
                                                  short_name)
            pairwise_results = compare_batch_results(flat)
            pairwise_results.pairwise_options = pairwise_options
            pairwise_results.comparison_short_name = short_name
            desc_a = pairwise_options.results_description_a or \
                os.path.basename(str(pairwise_options.results_filename_a))
            desc_b = pairwise_options.results_description_b or \
                os.path.basename(str(pairwise_options.results_filename_b))
            pairwise_results.comparison_friendly_name = \
                '{} vs {}'.format(desc_a, desc_b)
            all_pairwise_results.append(pairwise_results)
            if getattr(pairwise_results, 'html_output_file', None):
                index_lines.append(
                    '<li><a href="{}">{}</a></li>\n'.format(
                        os.path.relpath(pairwise_results.html_output_file,
                                        options.output_folder),
                        pairwise_results.comparison_friendly_name))

        results = BatchComparisonResults()
        results.pairwise_results = all_pairwise_results
        if options.output_folder is not None:
            os.makedirs(options.output_folder, exist_ok=True)
            index_html = os.path.join(options.output_folder,
                                      'index.html')
            with open(index_html, 'w') as f:
                f.write('<html><body>\n<h1>Results comparison: {}</h1>'
                        '\n<ul>\n'.format(options.job_name))
                for line in index_lines:
                    f.write(line)
                f.write('</ul>\n</body></html>\n')
            results.html_output_file = index_html
        return results

    with open(options.results_filename_a) as f:
        results_a = json.load(f)
    with open(options.results_filename_b) as f:
        results_b = json.load(f)

    gt = _load_ground_truth(options)
    pairwise = _pairwise_compare_batch_results(options, results_a,
                                               results_b, gt=gt)

    if options.output_folder is None:
        return pairwise

    os.makedirs(options.output_folder, exist_ok=True)
    rng = random.Random(options.random_seed)

    desc_a = options.results_description_a or \
        os.path.basename(options.results_filename_a)
    desc_b = options.results_description_b or \
        os.path.basename(options.results_filename_b)

    images_a = {im['file']: im for im in results_a['images']}
    images_b = {im['file']: im for im in results_b['images']}
    categories_a = results_a.get('detection_categories', {})
    categories_b = results_b.get('detection_categories', {})
    classification_categories_a = \
        results_a.get('classification_categories') or None
    classification_categories_b = \
        results_b.get('classification_categories') or None

    index_html = os.path.join(options.output_folder, 'index.html')
    page_lines = []

    for key in sorted(pairwise.categories_to_image_files.keys()):
        files = pairwise.categories_to_image_files[key]
        sample = files
        if options.max_images_per_category is not None and \
                len(files) > options.max_images_per_category:
            sample = rng.sample(files, options.max_images_per_category)
        if options.sort_by_confidence:
            sample = sorted(
                sample,
                key=lambda fn: -pairwise.file_to_sort_conf.get(fn, 0.0))
        else:
            sample = sorted(sample)
        page_fn = os.path.join(options.output_folder, key + '.html')

        render_jobs = []
        rows = []  # (fn, img_a_rel, img_b_rel) — rel paths or None
        if options.render_images and options.image_folder:
            render_dir = os.path.join(options.output_folder, 'rendered',
                                      key)
            for i_fn, fn in enumerate(sample):
                source = os.path.join(options.image_folder, fn)
                safe = fn.replace('/', '~').replace('\\', '~')[-80:]
                target_a = os.path.join(
                    render_dir, '{:0>5d}_A_{}.jpg'.format(i_fn, safe))
                target_b = os.path.join(
                    render_dir, '{:0>5d}_B_{}.jpg'.format(i_fn, safe))
                gt_annotations = None
                gt_categories = None
                if gt is not None:
                    gt_annotations = \
                        gt['annotations_by_file'].get(fn, [])
                    gt_categories = gt['categories']
                render_jobs.append(
                    (source, images_a[fn], images_b[fn], categories_a,
                     categories_b, classification_categories_a,
                     classification_categories_b, target_a, target_b,
                     options, gt_annotations, gt_categories))

            if options.parallelize_rendering and len(render_jobs) > 1:
                import multiprocessing
                from concurrent.futures import (ProcessPoolExecutor,
                                                ThreadPoolExecutor)
                n_cores = options.parallelize_rendering_n_cores
                if options.parallelize_rendering_with_threads:
                    pool = ThreadPoolExecutor(max_workers=n_cores)
                else:
                    # Spawned, not forked: the caller may hold a CUDA
                    # context and loader threads
                    pool = ProcessPoolExecutor(
                        max_workers=n_cores,
                        mp_context=multiprocessing.get_context('spawn'))
                with pool:
                    rendered = list(pool.map(_render_pair_image,
                                             render_jobs))
            else:
                rendered = [_render_pair_image(j) for j in render_jobs]

            for fn, r in zip(sample, rendered):
                if r is None:
                    rows.append((fn, None, None))
                else:
                    rows.append((
                        fn,
                        os.path.relpath(r[0], options.output_folder),
                        os.path.relpath(r[1], options.output_folder)))
        else:
            rows = [(fn, None, None) for fn in sample]

        # Paginate beyond max_images_per_page (reference :146-148)
        per_page = options.max_images_per_page
        if per_page is not None and len(rows) > per_page:
            chunks = [rows[i:i + per_page]
                      for i in range(0, len(rows), per_page)]
        else:
            chunks = [rows]

        base_name, ext = os.path.splitext(page_fn)
        page_files = [page_fn] if len(chunks) == 1 else [
            '{}_page{:0>3d}{}'.format(base_name, i, ext)
            for i in range(len(chunks))]

        def write_rows(f, rows_chunk):
            for fn, img_a, img_b in rows_chunk:
                f.write('<h3>{}</h3>\n'.format(fn))
                if gt is not None and \
                        gt['type'] == 'image_level_gt' and \
                        options.show_labels_for_image_level_gt:
                    names = sorted(set(
                        str(gt['categories'].get(a['category_id'],
                                                 a['category_id']))
                        for a in
                        gt['annotations_by_file'].get(fn, [])))
                    if names:
                        f.write('<p>Ground truth: {}</p>\n'.format(
                            ', '.join(names)))
                if img_a is not None:
                    f.write(
                        '<table><tr>'
                        '<td style="vertical-align:top;padding:4px">'
                        '<b>{}</b> ({})<br/>'
                        '<img src="{}"/></td>'
                        '<td style="vertical-align:top;padding:4px">'
                        '<b>{}</b> ({})<br/>'
                        '<img src="{}"/></td>'
                        '</tr></table>\n'.format(
                            desc_a,
                            _detection_summary(images_a[fn],
                                               options.
                                               rendering_confidence_threshold_a),
                            img_a,
                            desc_b,
                            _detection_summary(images_b[fn],
                                               options.
                                               rendering_confidence_threshold_b),
                            img_b))
                else:
                    src = os.path.join(options.image_folder, fn) \
                        if options.image_folder else fn
                    f.write('<img src="{}"/>\n'.format(src))

        nav = ''
        if len(chunks) > 1:
            nav = '<p>{}</p>\n'.format(' | '.join(
                '<a href="{}">page {}</a>'.format(
                    os.path.basename(pf), i)
                for i, pf in enumerate(page_files)))
        for i_chunk, (chunk, chunk_fn) in enumerate(
                zip(chunks, page_files)):
            with open(chunk_fn, 'w') as f:
                f.write('<html><head><meta charset="utf-8"/></head>'
                        '<body>\n')
                f.write('<h1>{}</h1>\n'.format(key))
                f.write(nav)
                f.write('<p>{} of {} images shown</p>\n'.format(
                    len(rows), len(files)))
                write_rows(f, chunk)
                f.write('</body></html>\n')
        if len(chunks) > 1:
            # The unsuffixed page is a nav index to the chunk pages
            with open(page_fn, 'w') as f:
                f.write('<html><body>\n<h1>{}</h1>\n{}</body></html>\n'
                        .format(key, nav))

        page_lines.append(
            '<li><a href="{}">{}</a>: {} images</li>\n'.format(
                os.path.basename(page_fn), key, len(files)))

    with open(index_html, 'w') as f:
        f.write('<html><body>\n<h1>Comparison: {} vs {}</h1>\n<ul>\n'
                .format(desc_a, desc_b))
        for line in page_lines:
            f.write(line)
        f.write('</ul>\n</body></html>\n')

    pairwise.html_output_file = index_html
    print('Wrote comparison to {}'.format(index_html))
    return pairwise


def n_way_comparison(filenames, options, detection_thresholds=None,
                     rendering_thresholds=None, model_names=None):
    """
    All-pairs comparison across N results files (reference:
    compare_batch_results.py:1700). Populates options.pairwise_options
    from [filenames] and defers to compare_batch_results(); returns a
    BatchComparisonResults whose .pairwise_results holds one entry per
    pair.
    """

    if detection_thresholds is None:
        detection_thresholds = [0.15] * len(filenames)
    assert len(detection_thresholds) == len(filenames), \
        '[detection_thresholds] should be the same length as [filenames]'
    if rendering_thresholds is not None:
        assert len(rendering_thresholds) == len(filenames), \
            '[rendering_thresholds] should be the same length as ' \
            '[filenames]'
    else:
        rendering_thresholds = [(x * 0.6666)
                                for x in detection_thresholds]
    if model_names is not None:
        assert len(model_names) == len(filenames), \
            '[model_names] should be the same length as [filenames]'

    import itertools
    options.pairwise_options = []
    for i_a, i_b in itertools.combinations(range(len(filenames)), 2):
        pairwise_options = PairwiseBatchComparisonOptions()
        pairwise_options.results_filename_a = filenames[i_a]
        pairwise_options.results_filename_b = filenames[i_b]
        if model_names is not None:
            pairwise_options.results_description_a = model_names[i_a]
            pairwise_options.results_description_b = model_names[i_b]
        pairwise_options.detection_thresholds_a = \
            detection_thresholds[i_a]
        pairwise_options.detection_thresholds_b = \
            detection_thresholds[i_b]
        pairwise_options.rendering_confidence_threshold_a = \
            rendering_thresholds[i_a]
        pairwise_options.rendering_confidence_threshold_b = \
            rendering_thresholds[i_b]
        options.pairwise_options.append(pairwise_options)

    return compare_batch_results(options)


def find_image_level_detections_above_threshold(results, threshold=0.2,
                                                category_names=None):
    """
    Images in the MD results [results] (a filename or a loaded dict)
    with at least one detection above [threshold], optionally counting
    only categories named in [category_names] (a list or a single name)
    (reference: compare_batch_results.py:1766).
    """

    if isinstance(results, str):
        with open(results, 'r') as f:
            results = json.load(f)

    category_ids_to_consider = None
    if category_names is not None:
        if isinstance(category_names, str):
            category_names = [category_names]
        name_to_id = ct_utils.invert_dictionary(
            results['detection_categories'])
        category_ids_to_consider = set()
        for name in category_names:
            assert name in name_to_id, \
                'Unknown category name {}'.format(name)
            category_ids_to_consider.add(name_to_id[name])

    images_with_detections = []
    for im in results['images']:
        for d in im.get('detections') or []:
            if category_ids_to_consider is not None and \
                    d['category'] not in category_ids_to_consider:
                continue
            if d['conf'] >= threshold:
                images_with_detections.append(im)
                break
    return images_with_detections


def find_equivalent_threshold(results_filename_a, results_filename_b,
                              threshold_a, category=None):
    """
    Find the threshold for model B that marks (approximately) the same
    number of images positive as threshold_a does for model A
    (reference: compare_batch_results.py:1827).
    """

    with open(results_filename_a) as f:
        results_a = json.load(f)
    with open(results_filename_b) as f:
        results_b = json.load(f)

    def max_confs(results):
        out = []
        for im in results['images']:
            dets = im.get('detections') or []
            if category is not None:
                dets = [d for d in dets if d['category'] == category]
            out.append(max([d['conf'] for d in dets], default=0.0))
        return sorted(out, reverse=True)

    confs_a = max_confs(results_a)
    confs_b = max_confs(results_b)
    n_positive_a = sum(1 for c in confs_a if c >= threshold_a)
    if n_positive_a == 0:
        return 1.0
    if n_positive_a > len(confs_b):
        return 0.0
    return confs_b[n_positive_a - 1]


def main():
    parser = argparse.ArgumentParser(
        description='Compare two MD results files')
    parser.add_argument('output_folder')
    parser.add_argument('image_folder')
    parser.add_argument('results_file_a')
    parser.add_argument('results_file_b')
    parser.add_argument('--detection_threshold_a', type=float,
                        default=0.15)
    parser.add_argument('--detection_threshold_b', type=float,
                        default=0.15)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    options = BatchComparisonOptions()
    options.output_folder = args.output_folder
    options.image_folder = args.image_folder
    options.results_filename_a = args.results_file_a
    options.results_filename_b = args.results_file_b
    options.detection_thresholds_a = args.detection_threshold_a
    options.detection_thresholds_b = args.detection_threshold_b
    compare_batch_results(options)


if __name__ == '__main__':
    main()
