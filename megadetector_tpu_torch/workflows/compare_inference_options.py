"""
Compare a variety of inference options (models, preprocessing
compatibility modes, canvas modes, image sizes, test-time augmentation,
tiling) on a folder of images, producing per-job MD results files,
per-job preview galleries, per-image cross-job review pages, and a
timing/agreement summary
(reference: notebooks/compare_inference_options.py:1-565).

The port's own copy of megadetector_tpu/workflows/compare_inference_options.py:
the same public names, signatures, defaults and output files, with
InferenceComparisonOptions.device added (None means the card; 'cpu' for
tests), which every job passes on to the port's drivers. The reference
round-robins its job grid across GPUs (one thread/process per GPU,
notebooks/compare_inference_options.py:255-310); here the jobs run one
after another on one card, because one batched job already keeps the card
busy. Each job loads its detector, whose program for each canvas shape is
run once eagerly, then captured as a CUDA graph and replayed for every
later batch, so the sweep doubles as a perf matrix: per-job wall time and
images/sec land in comparison_summary.json.
"""

import argparse
import json
import os
import shutil
import sys
import time

from megadetector_tpu_torch.detection import run_detector
from megadetector_tpu_torch.detection.run_detector_batch import \
    load_and_run_detector_batch, write_results_to_file
from megadetector_tpu_torch.detection.run_tiled_inference import \
    run_tiled_inference
from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils import path_utils
from megadetector_tpu_torch.utils.write_html_image_list import \
    write_html_image_list
from megadetector_tpu_torch.visualization.visualize_detector_output import \
    visualize_detector_output


#%% Options


class InferenceComparisonOptions:
    """
    Options for compare_inference_options(); the grid fields mirror the
    reference notebook's constants
    (notebooks/compare_inference_options.py:29-47).
    """

    def __init__(self):

        #: Folder of images to run every job on
        self.input_folder = None

        #: Output folder; receives json_files/, visualization/,
        #: image_review/, comparison_summary.json
        self.output_folder = None

        #: Model files or known model names to sweep
        self.model_files = []

        #: Preprocessing compatibility modes to sweep
        self.compatibility_modes = ['modern']

        #: Canvas modes to sweep ('auto' = minimal stride rectangles,
        #: 'square' = fixed square canvas); an axis with no reference
        #: analog
        self.canvas_modes = ['auto']

        #: Inference canvas sizes; None = the model default
        self.image_sizes = [None]

        #: Test-time-augmentation states to sweep
        self.augment_states = [False]

        #: Tiling states to sweep
        self.tiling_states = [False]

        #: Tile geometry for tiling jobs
        self.tile_size_x = 1280
        self.tile_size_y = 1280
        self.tile_overlap = 0.5

        #: Images per compiled device step
        self.batch_size = 8

        #: Output confidence floor
        self.detection_threshold = None

        #: Rendering threshold for previews
        self.rendering_threshold = 0.025

        #: Max images rendered per job preview (-1 = all)
        self.visualization_sample = 1000

        #: Rendered preview width
        self.output_image_width = 1200

        #: Skip jobs whose output file already exists
        self.skip_finished_jobs = True

        #: Also build per-image pages showing every job's rendering of
        #: that image side by side
        self.build_image_review_pages = True

        #: Run all-pairs agreement analysis over the job outputs (caps
        #: at max_agreement_jobs outputs to keep the pair count sane)
        self.compute_agreement = True
        self.max_agreement_jobs = 8

        #: Extra detector options applied to every job
        self.detector_options = None

        #: Recurse into the input folder
        self.recursive = True

        #: Device of every job's detector: 'cuda', 'cuda:N', 'cpu' or
        #: None (CUDA; raises without a card)
        self.device = None


#%% Job assembly


def parameters_to_name(parameters):
    """
    Stable job name from a parameter dict: sorted keys, values joined
    with '_' (reference: compare_inference_options.py:57-60).
    """

    fields = sorted(parameters.keys())
    return '_'.join(str(parameters[f]) for f in fields).lower()


def assemble_comparison_jobs(options):
    """
    Expand the option grid into a list of job dicts with 'job_index',
    'job_name', 'job_output_file', and 'params'
    (reference: compare_inference_options.py:85-127).
    """

    assert options.model_files, 'No models specified'
    json_output_folder = os.path.join(options.output_folder, 'json_files')

    # Model identity comes from the file basename; two different model
    # files with the same basename (e.g. runA/best.npz vs runB/best.npz)
    # must not collide on job_name/job_output_file, so disambiguate
    # duplicates with their position in the model list.
    model_tags = [os.path.splitext(os.path.basename(str(f)))[0]
                  for f in options.model_files]
    duplicated_tags = {t for t in model_tags if model_tags.count(t) > 1}
    model_tags = [('{}-m{}'.format(t, i) if t in duplicated_tags else t)
                  for i, t in enumerate(model_tags)]

    jobs = []
    for model_file, model_tag in zip(options.model_files, model_tags):
        for compatibility_mode in options.compatibility_modes:
            for canvas_mode in options.canvas_modes:
                for image_size in options.image_sizes:
                    for augment in options.augment_states:
                        for tiling in options.tiling_states:
                            params = {
                                'model_name': model_tag,
                                'compatibility_mode': compatibility_mode,
                                'canvas': canvas_mode,
                                'image_size': image_size,
                                'aug': 'aug' if augment else 'noaug',
                                'tiling':
                                    'tiling' if tiling else 'no-tiling',
                            }
                            job = {
                                'job_index': len(jobs),
                                'job_name': parameters_to_name(params),
                                'params': params,
                                'model_file': model_file,
                                'image_size': image_size,
                                'augment': bool(augment),
                                'tiling': bool(tiling),
                            }
                            job['job_output_file'] = os.path.join(
                                json_output_folder,
                                job['job_name'] + '.json')
                            jobs.append(job)
    return jobs


#%% Job execution


def _job_detector_options(job, options):

    detector_options = dict(options.detector_options or {})
    detector_options['compatibility_mode'] = \
        job['params']['compatibility_mode']
    detector_options['canvas_mode'] = job['params']['canvas']
    return detector_options


def run_comparison_job(job, options, image_file_names):
    """
    Run one job of the grid; writes the MD results file and records
    'elapsed'/'images_per_second' on the job dict. Skips (returning
    False) when the output exists and skip_finished_jobs is set.
    """

    output_file = job['job_output_file']
    if options.skip_finished_jobs and os.path.isfile(output_file):
        job['skipped'] = True
        return False

    os.makedirs(os.path.dirname(output_file), exist_ok=True)
    detector_options = _job_detector_options(job, options)
    threshold = options.detection_threshold if \
        options.detection_threshold is not None else \
        run_detector.DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD

    start = time.time()
    if job['tiling']:
        run_tiled_inference(
            model_file=job['model_file'],
            image_folder=options.input_folder,
            tiling_folder=None,
            output_file=output_file,
            tile_size_x=options.tile_size_x,
            tile_size_y=options.tile_size_y,
            tile_overlap=options.tile_overlap,
            recursive=options.recursive,
            batch_size=options.batch_size,
            detection_threshold=threshold,
            detector_options=detector_options,
            image_size=job['image_size'],
            augment=job['augment'],
            device=options.device)
    else:
        results = load_and_run_detector_batch(
            model_file=job['model_file'],
            image_file_names=list(image_file_names),
            confidence_threshold=threshold,
            quiet=True,
            image_size=job['image_size'],
            batch_size=options.batch_size,
            augment=job['augment'],
            detector_options=detector_options,
            device=options.device)
        write_results_to_file(
            results, output_file,
            relative_path_base=options.input_folder,
            detector_file=str(job['model_file']))

    job['elapsed'] = time.time() - start
    job['images_per_second'] = \
        len(image_file_names) / job['elapsed'] if job['elapsed'] > 0 \
        else None
    job['skipped'] = False
    return True


#%% Visualization / review pages


def visualize_comparison_jobs(options, jobs):
    """
    Render a preview gallery for every job
    (reference: compare_inference_options.py:317-368); records
    'visualization_folder' on each job.
    """

    visualization_folder = os.path.join(options.output_folder,
                                        'visualization')
    for job in jobs:
        job_folder = os.path.join(visualization_folder, job['job_name'])
        job['visualization_folder'] = job_folder
        rendered = visualize_detector_output(
            job['job_output_file'], job_folder, options.input_folder,
            confidence_threshold=options.rendering_threshold,
            sample=options.visualization_sample,
            output_image_width=options.output_image_width,
            random_seed=0)
        index_file = os.path.join(job_folder, 'index.html')
        write_html_image_list(
            filename=index_file,
            images=[os.path.basename(r) for r in rendered],
            options={'headerHtml':
                     '<h2>Comparison results: {}</h2>'.format(
                         job['job_name'])})
        job['html_output_file'] = index_file


def build_image_review_pages(options, jobs, image_files_relative):
    """
    One page per image showing every job's rendering side by side, plus
    a master index (reference: compare_inference_options.py:374-443).
    Rendered files are matched by the '~'-flattened relative path used
    by visualize_detector_output. Returns the master index path.
    """

    review_folder = os.path.join(options.output_folder, 'image_review')
    os.makedirs(review_folder, exist_ok=True)

    # job name -> {flattened image name -> rendered filename}
    job_renderings = {}
    for job in jobs:
        folder = job.get('visualization_folder')
        mapping = {}
        if folder and os.path.isdir(folder):
            for fn in os.listdir(folder):
                if not fn.startswith('anno_'):
                    continue
                # anno_{index:05d}_{flattened}
                flattened = fn.split('_', 2)[-1]
                mapping[flattened] = fn
        job_renderings[job['job_name']] = mapping

    image_to_index = {}
    for image_fn_relative in image_files_relative:
        flattened = image_fn_relative.replace('/', '~').replace('\\', '~')
        page_folder = os.path.join(
            review_folder, flattened.replace('~', '_'))
        image_info = []
        for job in jobs:
            source_name = job_renderings[job['job_name']].get(flattened)
            if source_name is None:
                continue
            target_name = '{}_{}{}'.format(
                os.path.splitext(source_name)[0], job['job_name'],
                os.path.splitext(source_name)[1])
            os.makedirs(page_folder, exist_ok=True)
            shutil.copyfile(
                os.path.join(job['visualization_folder'], source_name),
                os.path.join(page_folder, target_name))
            image_info.append({'filename': target_name,
                               'title': job['job_name']})
        if not image_info:
            continue
        index_file = os.path.join(page_folder, 'index.html')
        write_html_image_list(filename=index_file, images=image_info)
        image_to_index[image_fn_relative] = index_file

    master_index = os.path.join(review_folder, 'index.html')
    with open(master_index, 'w') as f:
        f.write('<html><body>\n')
        for image_fn_relative, index_file in image_to_index.items():
            f.write('<a href="{}">{}</a><br/>\n'.format(
                os.path.relpath(index_file, review_folder),
                image_fn_relative))
        f.write('</body></html>\n')
    return master_index


#%% Agreement + summary


def compute_job_agreement(options, jobs):
    """
    All-pairs agreement stats across job outputs via
    compare_batch_results.n_way_comparison; returns a list of pairwise
    summaries (statistics only — side-by-side galleries belong to
    compare_batch_results itself).
    """

    from megadetector_tpu_torch.postprocessing.compare_batch_results import \
        BatchComparisonOptions, n_way_comparison

    filenames = [j['job_output_file'] for j in jobs
                 if os.path.isfile(j['job_output_file'])]
    if len(filenames) < 2:
        return []
    if len(filenames) > options.max_agreement_jobs:
        print('Limiting agreement analysis to the first {} of {} '
              'job outputs'.format(options.max_agreement_jobs,
                                   len(filenames)))
        filenames = filenames[:options.max_agreement_jobs]

    pair_options = BatchComparisonOptions()
    pair_options.output_folder = None
    pairwise = n_way_comparison(filenames, pair_options).pairwise_results

    summaries = []
    for p in pairwise:
        category_counts = {k: len(v) for k, v in
                           p.categories_to_image_files.items()}
        summaries.append({
            'results_filename_a': p.filename_a,
            'results_filename_b': p.filename_b,
            'category_counts': category_counts,
        })
    return summaries


def write_comparison_summary(options, jobs, agreement=None):
    """Write comparison_summary.json; returns its path."""

    summary = {
        'input_folder': options.input_folder,
        'jobs': [
            {k: job[k] for k in
             ('job_index', 'job_name', 'job_output_file', 'params',
              'elapsed', 'images_per_second', 'skipped',
              'html_output_file') if k in job}
            for job in jobs
        ],
    }
    if agreement:
        summary['pairwise_agreement'] = agreement
    summary_file = os.path.join(options.output_folder,
                                'comparison_summary.json')
    ct_utils.write_json(summary_file, summary)
    return summary_file


#%% Orchestration


def compare_inference_options(options):
    """
    Run the full comparison: assemble the grid, run every job, render
    previews, build review pages, compute agreement, write the summary.
    Returns the summary dict (with 'summary_file' added).
    """

    assert options.input_folder and \
        os.path.isdir(options.input_folder), \
        'Invalid input folder {}'.format(options.input_folder)
    assert options.output_folder, 'No output folder specified'
    os.makedirs(options.output_folder, exist_ok=True)

    image_files_relative = path_utils.find_images(
        options.input_folder, recursive=options.recursive,
        return_relative_paths=True)
    image_files_abs = [os.path.join(options.input_folder, fn)
                       for fn in image_files_relative]
    jobs = assemble_comparison_jobs(options)
    print('Running {} jobs over {} images ({} total inferences)'.format(
        len(jobs), len(image_files_abs),
        len(jobs) * len(image_files_abs)))

    for job in jobs:
        print('Job {}/{}: {}'.format(
            job['job_index'] + 1, len(jobs), job['job_name']))
        ran = run_comparison_job(job, options, image_files_abs)
        if not ran:
            print('  output exists, skipped')
        elif job.get('images_per_second'):
            print('  {:.1f}s ({:.2f} images/sec)'.format(
                job['elapsed'], job['images_per_second']))

    visualize_comparison_jobs(options, jobs)
    if options.build_image_review_pages:
        master = build_image_review_pages(options, jobs,
                                          image_files_relative)
        print('Image review index: {}'.format(master))

    agreement = compute_job_agreement(options, jobs) \
        if options.compute_agreement else None
    summary_file = write_comparison_summary(options, jobs, agreement)
    print('Summary written to {}'.format(summary_file))

    with open(summary_file) as f:
        summary = json.load(f)
    summary['summary_file'] = summary_file
    return summary


#%% CLI


def main():

    parser = argparse.ArgumentParser(
        description='Compare inference options (models, preprocessing, '
                    'image sizes, TTA, tiling) on a folder of images')
    parser.add_argument('input_folder')
    parser.add_argument('output_folder')
    parser.add_argument('--model_files', nargs='+', required=True,
                        help='model files or known model names')
    parser.add_argument('--compatibility_modes', nargs='+',
                        default=['modern'])
    parser.add_argument('--canvas_modes', nargs='+', default=['auto'],
                        choices=['auto', 'square'])
    parser.add_argument('--image_sizes', nargs='+', default=['default'],
                        help='canvas sizes to sweep; "default" = the '
                             'model default')
    parser.add_argument('--augment', default='off',
                        choices=['off', 'on', 'both'])
    parser.add_argument('--tiling', default='off',
                        choices=['off', 'on', 'both'])
    parser.add_argument('--tile_size_x', type=int, default=1280)
    parser.add_argument('--tile_size_y', type=int, default=1280)
    parser.add_argument('--tile_overlap', type=float, default=0.5)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--threshold', type=float, default=None)
    parser.add_argument('--rendering_threshold', type=float,
                        default=0.025)
    parser.add_argument('--visualization_sample', type=int, default=1000)
    parser.add_argument('--no_image_review_pages', action='store_true')
    parser.add_argument('--no_agreement', action='store_true')
    parser.add_argument('--overwrite', action='store_true',
                        help='re-run jobs whose output already exists')
    parser.add_argument('--detector_options', nargs='*', default=None)
    parser.add_argument('--device', default=None,
                        help='cuda, cuda:N or cpu (default: cuda, which '
                             'needs a card)')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()

    def _tristate(v):
        return {'off': [False], 'on': [True],
                'both': [False, True]}[v]

    options = InferenceComparisonOptions()
    options.input_folder = args.input_folder
    options.output_folder = args.output_folder
    options.model_files = args.model_files
    options.compatibility_modes = args.compatibility_modes
    options.canvas_modes = args.canvas_modes
    options.image_sizes = [
        None if s in ('default', 'none') else int(s)
        for s in args.image_sizes]
    options.augment_states = _tristate(args.augment)
    options.tiling_states = _tristate(args.tiling)
    options.tile_size_x = args.tile_size_x
    options.tile_size_y = args.tile_size_y
    options.tile_overlap = args.tile_overlap
    options.batch_size = args.batch_size
    options.detection_threshold = args.threshold
    options.rendering_threshold = args.rendering_threshold
    options.visualization_sample = args.visualization_sample
    options.build_image_review_pages = not args.no_image_review_pages
    options.compute_agreement = not args.no_agreement
    options.skip_finished_jobs = not args.overwrite
    options.detector_options = ct_utils.parse_kvp_list(
        args.detector_options)
    options.device = args.device

    compare_inference_options(options)


if __name__ == '__main__':
    main()
