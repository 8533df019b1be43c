"""
Render an HTML preview of a batch of detection results: sampled images in
per-category pages (detections by category, non-detections, optional
"almost detections"), with boxes drawn; given COCO-CT ground truth,
additionally compute precision/recall and per-image TP/FP/TN/FN pages.

Behavioral contract follows the reference
(megadetector/postprocessing/postprocess_batch_results.py:78-2152):
category pages named detections_animal / detections_person /
detections_vehicle / multiple categories / non_detections /
almost_detections, sampling with a fixed seed, thumbnail rendering in a
parallel pool, index.html linking the subpages with counts and
percentages. When classification results are present (two-stage
pipelines), class labels render on the boxes, each image joins
class_<name> gallery pages by top-1 classification (class_unreliable
below the classification threshold; reference :905-937), and the index
gains a classification category report.

The port's own copy of
megadetector_tpu/postprocessing/postprocess_batch_results.py: the same
public names, signatures, defaults and output bytes. No progress bars: the
card's machine is not promised tqdm. Process pools are spawned, not
forked: the caller may hold a CUDA context and loader threads.
"""

import argparse
import collections
import json
import multiprocessing
import os
import random
import sys
import zlib

from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils.write_html_image_list import \
    write_html_image_list
from megadetector_tpu_torch.visualization import \
    visualization_utils as vis_utils


from enum import IntEnum


class DetectionStatus(IntEnum):
    """
    Flags used to mark images as positive or negative for P/R analysis
    according to ground truth and/or detector output (reference:
    postprocess_batch_results.py:285-306).
    """

    DS_NEGATIVE = 0
    DS_POSITIVE = 1
    #: Anything greater than this isn't clearly positive or negative
    DS_MAX_DEFINITIVE_VALUE = DS_POSITIVE
    #: Image has annotations suggesting both negative and positive
    DS_AMBIGUOUS = 2
    #: Image is not annotated, or is annotated as unknown/unlabeled
    DS_UNKNOWN = 3
    #: Image has not yet been assigned a state
    DS_UNASSIGNED = 4


def is_sas_url(s):
    """
    Heuristically check whether [s] is an Azure SAS URL (reference:
    postprocess_batch_results.py:406-415).
    """

    return (s.startswith(('http://', 'https://'))
            and ('core.windows.net' in s) and ('?' in s))


def relative_sas_url(folder_url, relative_path):
    """
    Given a container- or folder-level SAS URL, create a SAS URL to the
    specified relative path (reference:
    postprocess_batch_results.py:418-438). Returns None if [folder_url]
    is not a SAS URL.
    """

    relative_path = relative_path.replace('%', '%25')
    relative_path = relative_path.replace('#', '%23')
    relative_path = relative_path.replace(' ', '%20')

    if not is_sas_url(folder_url):
        return None
    tokens = folder_url.split('?')
    assert len(tokens) == 2
    if not tokens[0].endswith('/'):
        tokens[0] = tokens[0] + '/'
    if relative_path.startswith('/'):
        relative_path = relative_path[1:]
    return tokens[0] + relative_path + '?' + tokens[1]


#: GT category names treated as negative / as neither-pos-nor-neg by
#: default (reference: postprocess_batch_results.py:60-76). The token
#: '#NO_LABELS#' in negative_classes means an image with no annotations
#: counts as empty.
DEFAULT_NEGATIVE_CLASSES = ['empty', 'blank', 'none', 'misfire',
                            '#NO_LABELS#']
DEFAULT_UNKNOWN_CLASSES = ['unknown', 'unidentified', 'unidentifiable',
                           'ambiguous']


class PostProcessingOptions:
    """Options controlling process_batch_results(). Field-level parity
    with the reference options class (reference:
    postprocess_batch_results.py:78-265); intentionally omitted fields
    are listed in COVERAGE.md."""

    def __init__(self):
        self.md_results_file = ''
        self.output_dir = ''
        self.image_base_dir = ''

        # None = pull the typical threshold from the results file's
        # detector metadata (or 0.2). Can also be a dict mapping
        # category NAMES to thresholds, with 'default' as the fallback
        # (reference :127-134)
        self.confidence_threshold = None

        # Images sampled per category page (-1 = all)
        self.num_images_to_sample = 1000
        self.sample_seed = 0
        self.viz_target_width = 1200
        self.line_thickness = 4
        self.box_expansion = 0
        self.sort_classification_results_by_count = False

        # Add an 'almost_detections' page for images whose max conf lands
        # in [almost_detection_confidence_threshold, confidence_threshold)
        self.include_almost_detections = False
        self.almost_detection_confidence_threshold = None

        # Classification-aware rendering (reference:
        # postprocess_batch_results.py:136-140,911-937): detections
        # whose top-1 classification clears this threshold send the
        # image to a 'class_<name>' gallery page; below it, to
        # 'class_unreliable'. Negative = no threshold (never
        # unreliable). Class labels also render on the boxes.
        self.classification_confidence_threshold = 0.5
        self.include_classification_category_report = True
        # Push generic classification categories ('blank', 'animal',
        # 'unreliable', ...) to the bottom of the report: name -> int
        # sort weight, default 0, larger = later (reference :216-230)
        self.category_name_to_sort_weight = {}
        # Include classification_category_descriptions (taxonomy
        # strings) in the category report (reference :257-259)
        self.include_category_descriptions_with_global_counts = False

        self.separate_detections_by_category = True
        self.parallelize_rendering = True
        self.parallelize_rendering_n_cores = 8
        # Threads (True) or processes (False) for the rendering pool
        self.parallelize_rendering_with_threads = True

        # Optional COCO-CT ground truth for P/R analysis
        self.ground_truth_json_file = None
        # GT classes treated as negative / as unknown (reference :105-113)
        self.negative_classes = list(DEFAULT_NEGATIVE_CLASSES)
        self.unlabeled_classes = list(DEFAULT_UNKNOWN_CLASSES)
        # Recall target for the per-class threshold report
        self.target_recall = 0.9

        # Page sets to count but not render (e.g. 'non_detections' on a
        # set with many empties; reference :117-125)
        self.rendering_bypass_sets = []

        # Sort order within gallery pages: 'filename', 'confidence', or
        # 'random' (reference :165)
        self.html_sort_order = 'filename'
        # Link each rendered thumbnail back to the original image
        self.link_images_to_originals = True
        # Paginate gallery pages beyond this many figures
        self.max_figures_per_html_file = 1000

        # Big-letter header strings for the index page
        self.job_name_string = None
        self.model_version_string = None

        # Filename string replacements, applied before resolving image
        # paths (re-rooting results onto a different folder structure;
        # reference :175-184)
        self.api_output_filename_replacements = {}
        self.ground_truth_filename_replacements = {}

        # Extra per-image fields to surface in gallery titles: list of
        # field names, or dict field -> display name (reference :246-249)
        self.additional_image_fields_to_display = None
        # Append the min/max normalized area of above-threshold
        # detections to each title (reference :261-264)
        self.include_size_range = False

        self.footer_text = ''
        # Character encoding for the HTML output (None = platform
        # default with utf-8 meta tags)
        self.output_html_encoding = None


class PostProcessingResults:
    """Results of process_batch_results()."""

    def __init__(self):
        self.output_html_file = None
        self.category_to_images = {}
        self.eval_metrics = None


def _threshold_for_category(threshold, category_id):
    """Per-category threshold: [threshold] is a float, or a dict keyed
    by category id with 'default' as the fallback (user-facing dicts
    are keyed by NAME and normalized to ids in process_batch_results;
    reference: postprocess_batch_results.py:127-134)."""

    if isinstance(threshold, dict):
        return threshold.get(category_id,
                             threshold.get('default', 0.2))
    return threshold


def _normalize_threshold_dict(threshold, detection_categories):
    """User-facing threshold dicts are keyed by category NAME; convert
    to id keys once so per-detection lookups are direct."""

    if not isinstance(threshold, dict):
        return threshold
    name_to_id = {v: k for k, v in detection_categories.items()}
    normalized = {}
    for key, value in threshold.items():
        if key == 'default':
            normalized['default'] = value
        else:
            normalized[name_to_id.get(key, key)] = value
    normalized.setdefault('default', 0.2)
    return normalized


def _image_category(im, detection_categories, threshold, options):
    """
    Page assignment for one image: 'detections_<cat>', 'multiple
    categories', 'non_detections', 'almost_detections', or 'failures'.
    """

    if im.get('detections') is None:
        return 'failures'

    above = set()
    max_margin = -1.0
    for d in im['detections']:
        t = _threshold_for_category(threshold, d['category'])
        # margin relative to the category's own threshold, so the
        # almost-detections band works under dict thresholds too
        max_margin = max(max_margin, d['conf'] - t)
        if d['conf'] >= t:
            above.add(detection_categories.get(d['category'],
                                               d['category']))

    if len(above) == 0:
        if options.include_almost_detections and \
                max_margin >= (options.almost_detection_confidence_threshold
                               - _threshold_for_category(threshold,
                                                         'default')):
            return 'almost_detections'
        return 'non_detections'
    if not options.separate_detections_by_category:
        return 'detections'
    if len(above) == 1:
        return 'detections_{}'.format(above.pop())
    return 'multiple categories'


def _classification_pages(im, page, classification_categories, threshold,
                          options):
    """
    Extra 'class_<name>' gallery pages this image belongs on, from the
    top-1 classification of each above-threshold detection (reference:
    postprocess_batch_results.py:905-937; 'class_unreliable' when the
    top-1 score misses the classification threshold). Returns a set.
    """

    if page in ('failures', 'non_detections'):
        return set()
    pages = set()
    for d in im.get('detections') or []:
        if d['conf'] < _threshold_for_category(threshold, d['category']):
            continue
        classifications = d.get('classifications') or []
        if len(classifications) == 0:
            continue
        class_id, class_conf = classifications[0][0], classifications[0][1]
        name = classification_categories.get(
            str(class_id), str(class_id))
        if options.classification_confidence_threshold < 0 or \
                class_conf >= options.classification_confidence_threshold:
            pages.add('class_{}'.format(name))
        else:
            pages.add('class_unreliable')
    return pages


def _top_classification_names(im, classification_categories, threshold):
    """Sorted unique top-1 class names over the image's above-threshold
    detections (for gallery titles); empty when no classifications."""

    names = set()
    for d in im.get('detections') or []:
        if d['conf'] < _threshold_for_category(threshold, d['category']):
            continue
        classifications = d.get('classifications') or []
        if classifications:
            class_id = str(classifications[0][0])
            names.add(classification_categories.get(class_id, class_id))
    return sorted(names)


def _render_image(job):
    """Render one sampled image with boxes to the output folder."""

    (im, source, target, detection_categories,
     classification_categories, threshold, options) = job
    try:
        image = vis_utils.load_image(source)
        detections = im.get('detections') or []
        vis_utils.render_detection_bounding_boxes(
            detections, image,
            label_map=detection_categories,
            classification_label_map=classification_categories or None,
            confidence_threshold=threshold,
            classification_confidence_threshold=max(
                0.0, options.classification_confidence_threshold),
            thickness=options.line_thickness,
            expansion=options.box_expansion)
        if options.viz_target_width is not None and \
                image.size[0] > options.viz_target_width:
            image = vis_utils.resize_image(
                image, target_width=options.viz_target_width)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        image.convert('RGB').save(target, quality=85)
        return True
    except Exception as e:
        print('Warning: rendering error for {}: {}'.format(source, e))
        # Write an explicit placeholder so gallery pages never show a
        # broken <img> (unreadable sources land on the failures page)
        try:
            from PIL import Image, ImageDraw
            placeholder = Image.new('RGB', (400, 100), (60, 60, 60))
            draw = ImageDraw.Draw(placeholder)
            draw.text((10, 10), 'unrenderable image:', fill=(255, 255, 255))
            draw.text((10, 40), os.path.basename(source)[-60:],
                      fill=(255, 255, 255))
            os.makedirs(os.path.dirname(target), exist_ok=True)
            placeholder.save(target, quality=85)
        except Exception:
            pass
        return False


def process_batch_results(options):
    """
    Build the HTML preview (and optional ground-truth eval). Returns a
    PostProcessingResults with output_html_file set.
    """

    with open(options.md_results_file) as f:
        data = json.load(f)

    detection_categories = data.get('detection_categories', {})

    threshold = options.confidence_threshold
    if threshold is None:
        md = data.get('info', {}).get('detector_metadata', {})
        threshold = md.get('typical_detection_threshold', 0.2)
    threshold = _normalize_threshold_dict(threshold, detection_categories)
    default_threshold = _threshold_for_category(threshold, 'default')

    if options.include_almost_detections and \
            options.almost_detection_confidence_threshold is None:
        options.almost_detection_confidence_threshold = \
            default_threshold * 0.5

    # Re-root results filenames onto a different folder structure
    # (reference: postprocess_batch_results.py:175-184)
    if options.api_output_filename_replacements:
        for im in data['images']:
            for old, new in \
                    options.api_output_filename_replacements.items():
                im['file'] = im['file'].replace(old, new)

    os.makedirs(options.output_dir, exist_ok=True)

    classification_categories = {
        str(k): v for k, v in
        (data.get('classification_categories') or {}).items()}

    # --- Assign images to pages (an image with classification results
    # appears on its detection page AND its class_<name> pages)
    category_to_images = collections.defaultdict(list)
    for im in data['images']:
        page = _image_category(im, detection_categories, threshold,
                               options)
        category_to_images[page].append(im)
        if classification_categories or any(
                'classifications' in d
                for d in im.get('detections') or []):
            for cls_page in _classification_pages(
                    im, page, classification_categories, threshold,
                    options):
                category_to_images[cls_page].append(im)

    # --- Sample
    rng = random.Random(options.sample_seed)
    sampled = {}
    for page, images in category_to_images.items():
        if options.num_images_to_sample is not None and \
                options.num_images_to_sample > 0 and \
                len(images) > options.num_images_to_sample:
            sampled[page] = rng.sample(images,
                                       options.num_images_to_sample)
        else:
            sampled[page] = images

    # --- Render thumbnails. Each sampled image renders exactly ONCE
    # into a shared rendered/ folder even when it appears on several
    # pages (detection page + class_<name> pages); page entries all
    # point at the shared file. Failed images (detections == None) are
    # rendered too (boxless), so the failures page shows the image when
    # it is readable and an explicit placeholder when it is not.
    bypass_sets = set(options.rendering_bypass_sets or [])
    render_jobs = {}
    page_entries = collections.defaultdict(list)
    rendered_dir = os.path.join(options.output_dir, 'rendered')
    for page, images in sampled.items():
        if page in bypass_sets:
            continue
        for im in images:
            source = os.path.join(options.image_base_dir, im['file'])
            target = os.path.join(
                rendered_dir, '{:08x}_{}.jpg'.format(
                    zlib.crc32(im['file'].encode('utf-8')),
                    im['file'].replace('/', '~').replace('\\', '~')[-80:]))
            max_conf = ct_utils.get_max_conf(im)
            title = '{} (max conf {:.3f})'.format(im['file'], max_conf)
            top_classes = _top_classification_names(
                im, classification_categories, threshold)
            if top_classes:
                title += ' ({})'.format(', '.join(top_classes))
            if options.include_size_range:
                sizes = [d['bbox'][2] * d['bbox'][3]
                         for d in (im.get('detections') or [])
                         if d['conf'] >= _threshold_for_category(
                             threshold, d['category'])]
                if sizes:
                    title += ' (size {:.4f}-{:.4f})'.format(
                        min(sizes), max(sizes))
            if options.additional_image_fields_to_display:
                fields = options.additional_image_fields_to_display
                display_names = fields if isinstance(fields, dict) else \
                    {fn: fn for fn in fields}
                for field, display in display_names.items():
                    if field in im:
                        title += ' ({}: {})'.format(display, im[field])
            if im.get('detections') is None and im.get('failure'):
                title += ' (failure: {})'.format(im['failure'])
            entry = {
                'filename': os.path.relpath(target, options.output_dir),
                'title': title,
                '_sort_conf': max_conf,
            }
            if options.link_images_to_originals:
                entry['linkTarget'] = os.path.abspath(source) \
                    if not is_sas_url(options.image_base_dir) else \
                    relative_sas_url(options.image_base_dir, im['file'])
            page_entries[page].append(entry)
            if target not in render_jobs:
                render_jobs[target] = (im, source, target,
                                       detection_categories,
                                       classification_categories,
                                       threshold, options)

    render_jobs = list(render_jobs.values())
    if options.parallelize_rendering and \
            options.parallelize_rendering_n_cores > 1 and render_jobs:
        n_cores = options.parallelize_rendering_n_cores
        if options.parallelize_rendering_with_threads:
            pool = ThreadPoolExecutor(max_workers=n_cores)
        else:
            # Spawned, not forked: the caller may hold a CUDA context and
            # loader threads
            pool = ProcessPoolExecutor(
                max_workers=n_cores,
                mp_context=multiprocessing.get_context('spawn'))
        with pool:
            list(pool.map(_render_image, render_jobs))
    else:
        for job in render_jobs:
            _render_image(job)

    # --- Per-page HTML
    sort_order = options.html_sort_order or 'filename'
    assert sort_order in ('filename', 'confidence', 'random'), \
        "html_sort_order must be 'filename', 'confidence', or 'random'"
    sort_rng = random.Random(options.sample_seed)
    page_to_html = {}
    for page, entries in page_entries.items():
        if sort_order == 'confidence':
            entries.sort(key=lambda e: -e['_sort_conf'])
        elif sort_order == 'random':
            sort_rng.shuffle(entries)
        else:
            entries.sort(key=lambda e: e['title'])
        for e in entries:
            e.pop('_sort_conf', None)
        page_html = os.path.join(options.output_dir,
                                 page.replace(' ', '_') + '.html')
        write_html_image_list(
            page_html, entries,
            options={'headerHtml': '<h1>{}</h1>'.format(page),
                     'maxFiguresPerHtmlFile':
                         options.max_figures_per_html_file,
                     'encoding': options.output_html_encoding})
        page_to_html[page] = page_html

    # --- Optional ground-truth eval
    eval_metrics = None
    if options.ground_truth_json_file is not None:
        eval_metrics = _evaluate_against_ground_truth(
            data, options.ground_truth_json_file, default_threshold,
            options=options)

    # --- Index page
    n_total = len(data['images'])
    index_html = os.path.join(options.output_dir, 'index.html')
    with open(index_html, 'w',
              encoding=options.output_html_encoding) as f:
        f.write('<html><head><meta charset="utf-8"/></head><body>\n')
        if options.job_name_string:
            f.write('<h1>{}</h1>\n'.format(options.job_name_string))
        f.write('<h1>Detection results preview</h1>\n')
        if options.model_version_string:
            f.write('<p>Model: {}</p>\n'.format(
                options.model_version_string))
        if isinstance(threshold, dict):
            per_cat = ', '.join(
                '{}: {:.3f}'.format(
                    detection_categories.get(k, k), v)
                for k, v in sorted(threshold.items()) if k != 'default')
            f.write('<p>Confidence thresholds: default {:.3f} ({}); '
                    '{} images total</p>\n'.format(
                        default_threshold, per_cat, n_total))
        else:
            f.write('<p>Confidence threshold: {:.3f}; {} images '
                    'total</p>\n'.format(threshold, n_total))
        f.write('<ul>\n')
        for page in sorted(category_to_images.keys()):
            n = len(category_to_images[page])
            n_sampled = len(sampled.get(page, []))
            pct = 100.0 * n / max(n_total, 1)
            link = os.path.basename(page_to_html[page]) \
                if page in page_to_html else None
            if link:
                f.write('<li><a href="{}">{}</a>: {} images ({:.1f}%), '
                        '{} sampled</li>\n'.format(link, page, n, pct,
                                                   n_sampled))
            else:
                f.write('<li>{}: {} images ({:.1f}%)</li>\n'.format(
                    page, n, pct))
        f.write('</ul>\n')

        # Classification category report (reference:
        # postprocess_batch_results.py:249-251): image counts per
        # class_<name> page, sorted by count or alphabetically
        class_pages = [p for p in category_to_images
                       if p.startswith('class_')]
        if class_pages and options.include_classification_category_report:
            descriptions = {}
            if options.include_category_descriptions_with_global_counts:
                name_by_id = classification_categories
                desc_by_id = {
                    str(k): v for k, v in
                    (data.get('classification_category_descriptions')
                     or {}).items()}
                descriptions = {
                    name_by_id[k]: desc_by_id.get(k, '')
                    for k in name_by_id}
            f.write('<h2>Classification categories</h2>\n')
            f.write('<table border=1 cellpadding=3 '
                    'style="border-collapse:collapse">'
                    '<tr><th>class</th><th>images</th>{}</tr>\n'.format(
                        '<th>description</th>' if descriptions else ''))
            # Weighted groups sort after unweighted ones (larger weight
            # == later); within a group, by count or alphabetically
            weights = options.category_name_to_sort_weight or {}

            def page_key(p):
                name = p[len('class_'):]
                secondary = -len(category_to_images[p]) \
                    if options.sort_classification_results_by_count \
                    else name
                return (int(weights.get(name, 0)), secondary)

            class_pages.sort(key=page_key)
            prev_weight = None
            for p in class_pages:
                name = p[len('class_'):]
                weight = int(weights.get(name, 0))
                if prev_weight is not None and weight != prev_weight:
                    n_cols = 3 if descriptions else 2
                    f.write('<tr><td colspan={}>&nbsp;</td></tr>\n'
                            .format(n_cols))
                prev_weight = weight
                desc_cell = '<td>{}</td>'.format(
                    descriptions.get(name, '')) if descriptions else ''
                f.write('<tr><td>{}</td><td>{}</td>{}</tr>\n'.format(
                    name, len(category_to_images[p]), desc_cell))
            f.write('</table>\n')

        if eval_metrics is not None:
            f.write('<h2>Ground-truth evaluation</h2>\n')
            f.write('<p>Image-level precision: {:.3f}, recall: {:.3f} '
                    '(at threshold {:.3f})</p>\n'.format(
                        eval_metrics['precision'],
                        eval_metrics['recall'], default_threshold))
            f.write('<p>TP {tp}, FP {fp}, TN {tn}, FN {fn}</p>\n'.format(
                **eval_metrics))
            curve = eval_metrics.get('precision_recall_curve')
            if curve:
                f.write('<p>Max F1 {:.3f} at threshold {:.2f}</p>\n'
                        .format(curve['max_f1'],
                                curve['max_f1_threshold']))
                # Compact P/R curve table at decile thresholds
                f.write('<table border=1 cellpadding=3 '
                        'style="border-collapse:collapse">'
                        '<tr><th>threshold</th><th>precision</th>'
                        '<th>recall</th><th>F1</th></tr>\n')
                for i in range(0, len(curve['thresholds']),
                               max(1, len(curve['thresholds']) // 10)):
                    f.write('<tr><td>{:.2f}</td><td>{:.3f}</td>'
                            '<td>{:.3f}</td><td>{:.3f}</td></tr>\n'
                            .format(curve['thresholds'][i],
                                    curve['precision'][i],
                                    curve['recall'][i],
                                    curve['f1'][i]))
                f.write('</table>\n')
            per_class = eval_metrics.get('per_class')
            if per_class and per_class['classes']:
                f.write('<h3>Per-class thresholds</h3>\n<ul>\n')
                for name, m in sorted(per_class['classes'].items()):
                    t = m['threshold_at_target_recall']
                    f.write('<li>{}: threshold for recall >= {:.0%}: '
                            '{}</li>\n'.format(
                                name, m['target_recall'],
                                '{:.2f}'.format(t) if t is not None
                                else 'unreachable'))
                f.write('</ul>\n')
                f.write('<h3>Confusion matrix (rows = ground truth)'
                        '</h3>\n')
                names = sorted(set(
                    list(per_class['confusion_matrix'].keys()) +
                    [p for row in
                     per_class['confusion_matrix'].values()
                     for p in row]))
                f.write('<table border=1 cellpadding=3 '
                        'style="border-collapse:collapse"><tr><th></th>')
                for n in names:
                    f.write('<th>{}</th>'.format(n))
                f.write('</tr>\n')
                for t_name in names:
                    row = per_class['confusion_matrix'].get(t_name, {})
                    f.write('<tr><th>{}</th>'.format(t_name))
                    for p_name in names:
                        f.write('<td>{}</td>'.format(
                            row.get(p_name, 0)))
                    f.write('</tr>\n')
                f.write('</table>\n')
        if options.footer_text:
            f.write('<p>{}</p>\n'.format(options.footer_text))
        f.write('</body></html>\n')

    results = PostProcessingResults()
    results.output_html_file = index_html
    results.category_to_images = dict(category_to_images)
    results.eval_metrics = eval_metrics
    print('Wrote preview to {}'.format(index_html))
    return results


def _evaluate_against_ground_truth(md_data, ground_truth_file, threshold,
                                   options=None):
    """
    Image-level P/R against a COCO Camera Traps ground-truth file: an
    image is ground-truth-positive if it has any annotation outside
    [options.negative_classes], predicted-positive if any detection >=
    threshold. Images whose only annotations are in
    [options.unlabeled_classes] are neither positive nor negative and
    are excluded from P/R (reference: postprocess_batch_results.py
    DetectionStatus handling :285-306,441-560). The '#NO_LABELS#' token
    in negative_classes makes unannotated images count as negative;
    without it they are excluded as unknown.
    """

    if options is None:
        options = PostProcessingOptions()

    with open(ground_truth_file) as f:
        gt = json.load(f)

    negative_names = set(
        c.lower() for c in (options.negative_classes or []))
    unknown_names = set(
        c.lower() for c in (options.unlabeled_classes or []))
    no_labels_is_negative = '#no_labels#' in negative_names

    negative_category_ids = set()
    unknown_category_ids = set()
    for cat in gt.get('categories', []):
        if cat['name'].lower() in negative_names:
            negative_category_ids.add(cat['id'])
        elif cat['name'].lower() in unknown_names:
            unknown_category_ids.add(cat['id'])

    gt_filename_replacements = \
        options.ground_truth_filename_replacements or {}

    def gt_key(fn):
        for old, new in gt_filename_replacements.items():
            fn = fn.replace(old, new)
        return fn

    # Per-image status from the set of annotation statuses: positive +
    # negative annotations -> DS_AMBIGUOUS; no annotations -> negative
    # (with '#NO_LABELS#') or unknown. Only clearly positive/negative
    # images enter P/R (reference DetectionStatus semantics).
    fn_by_id = {im['id']: gt_key(im.get('file_name', im['id']))
                for im in gt.get('images', [])}
    ann_statuses = collections.defaultdict(set)
    for ann in gt.get('annotations', []):
        cat = ann.get('category_id')
        if cat in unknown_category_ids:
            s = DetectionStatus.DS_UNKNOWN
        elif cat in negative_category_ids:
            s = DetectionStatus.DS_NEGATIVE
        else:
            s = DetectionStatus.DS_POSITIVE
        ann_statuses[ann['image_id']].add(s)

    base_status = DetectionStatus.DS_NEGATIVE if no_labels_is_negative \
        else DetectionStatus.DS_UNKNOWN
    status_by_key = {}
    for im in gt.get('images', []):
        statuses = ann_statuses.get(im['id'], set())
        if DetectionStatus.DS_POSITIVE in statuses and \
                DetectionStatus.DS_NEGATIVE in statuses:
            status = DetectionStatus.DS_AMBIGUOUS
        elif DetectionStatus.DS_POSITIVE in statuses:
            status = DetectionStatus.DS_POSITIVE
        elif DetectionStatus.DS_NEGATIVE in statuses:
            status = DetectionStatus.DS_NEGATIVE
        elif statuses:
            status = DetectionStatus.DS_UNKNOWN
        else:
            status = base_status
        status_by_key[im['id']] = status
        status_by_key[fn_by_id[im['id']]] = status

    image_id_to_positive = {
        k: v == DetectionStatus.DS_POSITIVE
        for k, v in status_by_key.items()
        if v in (DetectionStatus.DS_POSITIVE,
                 DetectionStatus.DS_NEGATIVE)}

    tp = fp = tn = fn_count = n_unknown = 0
    for im in md_data['images']:
        key = im['file']
        if key not in image_id_to_positive:
            if key in status_by_key:
                n_unknown += 1
            continue
        gt_positive = image_id_to_positive[key]
        pred_positive = any(
            d['conf'] >= threshold for d in (im.get('detections') or []))
        if gt_positive and pred_positive:
            tp += 1
        elif gt_positive:
            fn_count += 1
        elif pred_positive:
            fp += 1
        else:
            tn += 1

    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn_count, 1)

    # Full P/R curve + per-class curves/thresholds + confusion matrix
    # (reference: postprocess_batch_results.py:45,589,952-1042)
    curves = compute_precision_recall_curves(
        md_data, image_id_to_positive)
    per_class = compute_per_class_metrics(
        md_data, gt, target_recall=options.target_recall,
        confusion_threshold=threshold)

    return {'tp': tp, 'fp': fp, 'tn': tn, 'fn': fn_count,
            'n_unknown': n_unknown,
            'precision': precision, 'recall': recall,
            'precision_recall_curve': curves,
            'per_class': per_class}


def compute_precision_recall_curves(md_data, image_id_to_positive,
                                    n_thresholds=101):
    """
    Image-level precision/recall/F1 over a threshold sweep. Returns
    {'thresholds', 'precision', 'recall', 'f1',
    'max_f1', 'max_f1_threshold'}.
    """

    scored = []
    for im in md_data['images']:
        key = im['file']
        if key not in image_id_to_positive:
            continue
        max_conf = max((d['conf'] for d in im.get('detections') or []),
                       default=0.0)
        scored.append((max_conf, image_id_to_positive[key]))
    if not scored:
        return None

    n_positive = sum(1 for _, p in scored if p)
    thresholds = [i / (n_thresholds - 1) for i in range(n_thresholds)]
    precisions = []
    recalls = []
    f1s = []
    for t in thresholds:
        tp = sum(1 for conf, p in scored if p and conf >= t)
        fp = sum(1 for conf, p in scored if not p and conf >= t)
        precision = tp / max(tp + fp, 1)
        recall = tp / max(n_positive, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-9)
        precisions.append(round(precision, 4))
        recalls.append(round(recall, 4))
        f1s.append(round(f1, 4))

    i_best = max(range(len(f1s)), key=lambda i: f1s[i])
    return {'thresholds': thresholds, 'precision': precisions,
            'recall': recalls, 'f1': f1s, 'max_f1': f1s[i_best],
            'max_f1_threshold': thresholds[i_best]}


def compute_per_class_metrics(md_data, gt, target_recall=0.9,
                              n_thresholds=101, confusion_threshold=0.0):
    """
    Per-detection-class P/R curves, the minimum threshold achieving
    [target_recall], and an image-level confusion matrix (rows = GT
    class, cols = predicted class; GT class = the image's non-empty
    annotation category, predicted = the highest-confidence detection's
    category at or above [confusion_threshold], else 'empty' — so the
    matrix agrees with the TP/FP/TN/FN numbers computed at the same
    threshold rather than counting sub-noise detections as
    predictions). The per-class P/R curves sweep all thresholds and are
    unaffected by [confusion_threshold]. Returns
    {'classes': {name: {...}},
    'confusion_matrix': {gt_name: {pred_name: count}}}.
    """

    from collections import defaultdict

    gt_cat_names = {c['id']: c['name'].lower()
                    for c in gt.get('categories', [])}
    empty_names = ('empty', 'blank', 'none', 'misfire')

    fn_by_id = {im['id']: im.get('file_name', im['id'])
                for im in gt.get('images', [])}
    image_to_gt_classes = defaultdict(set)
    for ann in gt.get('annotations', []):
        name = gt_cat_names.get(ann.get('category_id'), 'unknown')
        key = fn_by_id.get(ann['image_id'], ann['image_id'])
        if name not in empty_names:
            image_to_gt_classes[key].add(name)

    md_categories = {k: v.lower() for k, v in
                     md_data.get('detection_categories', {}).items()}

    # Per-class score lists: for each MD class, images whose GT
    # includes that class are positives
    class_scores = defaultdict(list)
    confusion = defaultdict(lambda: defaultdict(int))
    gt_files = set()
    for im in gt.get('images', []):
        gt_files.add(im.get('file_name', im['id']))

    for im in md_data['images']:
        key = im['file']
        if key not in gt_files:
            continue
        gt_classes = image_to_gt_classes.get(key, set())
        per_class_conf = defaultdict(float)
        best = None
        for d in im.get('detections') or []:
            name = md_categories.get(d['category'], d['category'])
            per_class_conf[name] = max(per_class_conf[name], d['conf'])
            if d['conf'] >= confusion_threshold and \
                    (best is None or d['conf'] > best[1]):
                best = (name, d['conf'])
        for name in set(list(per_class_conf) + list(gt_classes)):
            class_scores[name].append(
                (per_class_conf.get(name, 0.0), name in gt_classes))
        gt_label = sorted(gt_classes)[0] if gt_classes else 'empty'
        pred_label = best[0] if best is not None else 'empty'
        confusion[gt_label][pred_label] += 1

    thresholds = [i / (n_thresholds - 1) for i in range(n_thresholds)]
    classes = {}
    for name, scored in class_scores.items():
        n_positive = sum(1 for _, p in scored if p)
        if n_positive == 0:
            continue
        precisions = []
        recalls = []
        threshold_at_recall = None
        for t in thresholds:
            tp = sum(1 for conf, p in scored if p and conf >= t)
            fp = sum(1 for conf, p in scored if not p and conf >= t)
            precision = tp / max(tp + fp, 1)
            recall = tp / max(n_positive, 1)
            precisions.append(round(precision, 4))
            recalls.append(round(recall, 4))
            if recall >= target_recall:
                threshold_at_recall = t
        classes[name] = {
            'n_positive_images': n_positive,
            'thresholds': thresholds,
            'precision': precisions,
            'recall': recalls,
            'threshold_at_target_recall': threshold_at_recall,
            'target_recall': target_recall,
        }

    return {'classes': classes,
            'confusion_matrix':
                {k: dict(v) for k, v in confusion.items()}}


def main():
    parser = argparse.ArgumentParser(
        description='Render an HTML preview of MD results')
    parser.add_argument('md_results_file')
    parser.add_argument('output_dir')
    parser.add_argument('--image_base_dir', default='')
    parser.add_argument('--confidence_threshold', type=float, default=None)
    parser.add_argument('--num_images_to_sample', type=int, default=1000)
    parser.add_argument('--include_almost_detections', action='store_true')
    parser.add_argument('--ground_truth_json_file', default=None)
    parser.add_argument('--html_sort_order', default='filename',
                        choices=['filename', 'confidence', 'random'])
    parser.add_argument('--max_figures_per_html_file', type=int,
                        default=1000)
    parser.add_argument('--job_name_string', default=None)
    parser.add_argument('--rendering_bypass_sets', nargs='*',
                        default=None,
                        help="page sets to count but not render, e.g. "
                             "non_detections")

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    options = PostProcessingOptions()
    ct_utils.args_to_object(args, options)
    process_batch_results(options)


if __name__ == '__main__':
    main()
