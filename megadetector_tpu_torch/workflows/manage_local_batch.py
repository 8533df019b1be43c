"""
The semi-automated batch-job workflow: enumerate -> run detector ->
validate -> preview -> repeat-detection elimination -> (optional)
classify -> smooth -> report, with consistent job-folder conventions.

Plays the role of the reference's notebooks/manage_local_batch.py
(:289-1964), which drives the same stage sequence by hand. Here each
stage is a method on BatchJob so the workflow is scriptable and
resumable; artifacts land in a standard job folder layout:

    <output_base>/<job_name>/
        <job_name>_detections.json
        <job_name>_detections_filtered.json      (after RDE)
        preview/index.html
        rde/filtering_*/
        report.csv

The port's own copy of megadetector_tpu/workflows/manage_local_batch.py:
the same public names, signatures, defaults and job folder, with
BatchJobOptions.device (None means the card; 'cpu' for tests), which the
detector and classifier stages pass on, and
BatchJobOptions.classifier_options (the SpeciesClassifier options, e.g.
{'dtype': 'bfloat16'}) added. One process drives one card: the detector
runs each canvas shape's program once eagerly, then captures it as a CUDA
graph and replays it for every later batch. The reference's per-GPU
chunking (manage_local_batch.py:494-785) is plan_chunks: one file list
and one command per chunk, merged with combine_batch_outputs.
estimate_time's default rate is this job's measured detection rate where
run_detector ran, else the card's (CARD_IMAGES_PER_SECOND).
"""

import json
import os

from datetime import datetime
from time import time

from megadetector_tpu_torch.detection import run_detector_batch
from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils import path_utils

# The detection stage's folder rate on an NVIDIA H100 80GB HBM3 at a 700 W
# power limit: chip_smoke.py phase 18, yolov5l6 in bf16 at 1280 px auto
# canvases, batch 8, 8 loader threads over 64 JPEGs (PERF.md, section 6)
CARD_IMAGES_PER_SECOND = 57.855

class BatchJobOptions:
    """Options controlling a BatchJob."""

    def __init__(self):
        self.model_file = 'MDV5A'
        self.input_path = None
        self.output_base = None
        self.job_name = None
        self.batch_size = 8
        self.image_size = None
        self.checkpoint_frequency = 1000
        self.confidence_threshold = None
        self.detector_options = None
        self.loader_workers = 8
        # RDE
        self.run_rde = True
        self.rde_occurrence_threshold = 20
        # Preview
        self.preview_sample_size = 500
        # Optional species classification stage
        self.classifier_model = None
        self.classification_confidence_threshold = 0.1
        # Optional classification smoothing after classification
        self.smooth_classifications = True
        # Also run sequence-level smoothing (requires sequence
        # information; see sequence_method)
        self.sequence_smoothing = False
        # How build_sequences determines sequences: 'exif' (EXIF
        # datetimes), 'folder' (each leaf folder is one sequence, the
        # frames-from-video convention), or 'json' (a CCT-formatted
        # file with seq_id/seq_num_frames/frame_num, via
        # cct_formatted_json) — reference notebook cells :1702-1850
        self.sequence_method = 'exif'
        self.cct_formatted_json = None
        # Same-family smoothing: force same-family minority species to
        # the dominant one (reference knob allow_same_family_smoothing,
        # manage_local_batch.py:344-348; don't set when multiple
        # species of one family co-occur in your sequences)
        self.allow_same_family_smoothing = False
        # Remove classifications from person/vehicle detections after
        # the classification stage (reference cell :1640)
        self.remove_classifications_from_non_animals = True
        # Optional custom taxa restriction (reference cells :326-342,
        # :1617, :1898): a taxa-list file, the taxonomy release file,
        # and whether to apply before or after smoothing
        self.custom_taxa_list = None
        self.custom_taxa_stage = 'before_smoothing'
        self.custom_taxa_allow_walk_down = False
        self.taxonomy_file = None
        # audit_results() raises when more than this many images failed
        # (reference knob max_tolerable_failed_images,
        # manage_local_batch.py:115)
        self.max_tolerable_failed_images = 100
        # Keep a preview from every pipeline stage (the reference's
        # preview chain) instead of only the final one
        self.preview_each_stage = False
        # SpeciesClassifier options of the classification stage (e.g.
        # {'dtype': 'bfloat16'} or {'quantize': 'int8'})
        self.classifier_options = None
        # Device of the detector and the classifier: 'cuda', 'cuda:N',
        # 'cpu' or None (CUDA; raises without a card)
        self.device = None


class BatchJob:
    """One camera-trap processing job; call the stage methods in order or
    run_all() for the full pipeline."""

    def __init__(self, options):
        assert options.input_path is not None
        assert options.output_base is not None
        self.options = options
        if options.job_name is None:
            options.job_name = '{}_{}'.format(
                os.path.basename(options.input_path.rstrip('/')),
                datetime.now().strftime('%Y%m%d%H%M%S'))
        self.job_dir = os.path.join(options.output_base,
                                    options.job_name)
        os.makedirs(self.job_dir, exist_ok=True)

        self.detections_file = os.path.join(
            self.job_dir, options.job_name + '_detections.json')
        self.filtered_file = os.path.join(
            self.job_dir, options.job_name + '_detections_filtered.json')
        self.preview_dir = os.path.join(self.job_dir, 'preview')
        self.rde_dir = os.path.join(self.job_dir, 'rde')
        self.report_file = os.path.join(self.job_dir, 'report.csv')
        self.final_file = self.detections_file

    #%% Stages

    def enumerate_images(self):
        """Stage 1: find images."""

        self.image_files = path_utils.find_images(
            self.options.input_path, recursive=True)
        print('Job {}: {} images'.format(self.options.job_name,
                                         len(self.image_files)))
        return self.image_files

    def run_detector(self):
        """Stage 2: batched detection with checkpointing; an existing
        job checkpoint (from a crashed run) is resumed automatically."""

        if not hasattr(self, 'image_files'):
            self.enumerate_images()
        checkpoint_path = os.path.join(
            self.job_dir, 'md_checkpoint.json')
        results = None
        if os.path.isfile(checkpoint_path):
            results = run_detector_batch.load_checkpoint(
                checkpoint_path)
            print('Resuming job {} from checkpoint with {} '
                  'results'.format(self.options.job_name, len(results)))
        start = time()
        n_done = len(results or [])
        results = run_detector_batch.load_and_run_detector_batch(
            self.options.model_file,
            self.image_files,
            results=results,
            checkpoint_path=checkpoint_path,
            checkpoint_frequency=self.options.checkpoint_frequency,
            confidence_threshold=self.options.confidence_threshold,
            batch_size=self.options.batch_size,
            image_size=self.options.image_size,
            detector_options=self.options.detector_options,
            loader_workers=self.options.loader_workers,
            device=self.options.device)
        elapsed = time() - start
        if len(results) > n_done and elapsed > 0:
            self.detection_images_per_second = \
                (len(results) - n_done) / elapsed
        run_detector_batch.write_results_to_file(
            results, self.detections_file,
            relative_path_base=self.options.input_path,
            detector_file=self.options.model_file if isinstance(
                self.options.model_file, str) else None)
        if os.path.isfile(checkpoint_path):
            os.remove(checkpoint_path)
        return self.detections_file

    def validate(self):
        """Stage 3: format validation."""

        from megadetector_tpu_torch.postprocessing \
            .validate_batch_results import (
            ValidateBatchResultsOptions, validate_batch_results)
        v_options = ValidateBatchResultsOptions()
        v_options.raise_errors = True
        validate_batch_results(self.final_file, v_options)
        print('Validation passed for {}'.format(self.final_file))

    def run_rde(self):
        """Stage 4: repeat-detection elimination (writes the review
        folder; apply with apply_rde() after human review, or rely on the
        auto-filtered output)."""

        if not self.options.run_rde:
            return None
        from megadetector_tpu_torch.postprocessing.repeat_detection_elimination \
            import repeat_detections_core as rde
        rde_options = rde.RepeatDetectionOptions()
        rde_options.occurrenceThreshold = \
            self.options.rde_occurrence_threshold
        rde_options.imageBase = self.options.input_path
        rde_options.outputBase = self.rde_dir
        results = rde.find_repeat_detections(
            self.detections_file, self.filtered_file, rde_options)
        self.final_file = self.filtered_file
        return results

    def apply_rde(self, filtering_folder):
        """Stage 4b: apply a human-reviewed filtering folder."""

        from megadetector_tpu_torch.postprocessing.repeat_detection_elimination \
            .remove_repeat_detections import remove_repeat_detections
        remove_repeat_detections(self.detections_file,
                                 self.filtered_file, filtering_folder)
        self.final_file = self.filtered_file

    def run_classifier(self):
        """
        Stage 4c (optional): species classification, then the
        reference's post-classification chain in its order
        (manage_local_batch.py:1617-1932): custom taxa
        (before_smoothing) -> strip non-animal classifications ->
        within-image smoothing -> sequence smoothing -> custom taxa
        (after_smoothing) -> remove unused categories.
        """

        if self.options.classifier_model is None:
            return None
        import json
        from megadetector_tpu_torch.models.classifier import (
            SpeciesClassifier, extract_crop)  # noqa: F401
        from megadetector_tpu_torch.detection.run_md_and_classifier import (
            MDAndClassifierOptions, _classify_detections_for_images)

        with open(self.final_file) as f:
            data = json.load(f)

        classifier = SpeciesClassifier(self.options.classifier_model,
                                       self.options.classifier_options,
                                       device=self.options.device)
        c_options = MDAndClassifierOptions()
        c_options.classification_confidence_threshold = \
            self.options.classification_confidence_threshold
        n = _classify_detections_for_images(
            data, self.options.input_path, classifier, c_options)
        print('Classified {} detections'.format(n))
        data['classification_categories'] = {
            str(i): name
            for i, name in enumerate(classifier.class_names)}

        classified_file = self.final_file.replace(
            '.json', '_classified.json')
        ct_utils.write_json(classified_file, data, force_str=True)
        self.final_file = classified_file

        o = self.options
        if o.custom_taxa_list is not None and \
                o.custom_taxa_stage == 'before_smoothing':
            self.apply_custom_taxa(o.custom_taxa_list, o.taxonomy_file,
                                   o.custom_taxa_allow_walk_down)
        if o.remove_classifications_from_non_animals:
            self.strip_nonanimal_classifications()
        if o.smooth_classifications:
            from megadetector_tpu_torch.postprocessing \
                .classification_postprocessing import \
                smooth_classification_results_image_level
            smooth_classification_results_image_level(
                self.final_file, self.final_file,
                options=self._smoothing_options())
        if o.sequence_smoothing:
            self.smooth_sequences()
        if o.custom_taxa_list is not None and \
                o.custom_taxa_stage == 'after_smoothing':
            self.apply_custom_taxa(o.custom_taxa_list, o.taxonomy_file,
                                   o.custom_taxa_allow_walk_down)
        self.remove_unused_categories()
        return self.final_file

    def _smoothing_options(self):
        """ClassificationSmoothingOptions honoring
        allow_same_family_smoothing (reference:
        manage_local_batch.py:1679-1680,1871-1872)."""

        from megadetector_tpu_torch.postprocessing \
            .classification_postprocessing import \
            ClassificationSmoothingOptions
        s_options = ClassificationSmoothingOptions()
        if self.options.allow_same_family_smoothing:
            s_options.max_detections_nondominant_class_same_family = 10000
        return s_options

    #%% Operator affordances (reference notebook cells :494-785,
    #%% :863-980, :1617-1971, :2037)

    def plan_chunks(self, n_chunks, per_chunk_detector_options=None):
        """
        Divide the image list into [n_chunks] jobs, writing a file list
        and a runnable shell command per chunk plus a combine command
        (the reference's per-GPU chunking, manage_local_batch.py:
        494-785: one process a card, each on its own chunk). Also prints
        a total-time estimate. Returns the script path.
        """

        if not hasattr(self, 'image_files'):
            self.enumerate_images()
        chunks = ct_utils.split_list_into_n_chunks(
            list(self.image_files), n_chunks)

        chunk_dir = os.path.join(self.job_dir, 'chunks')
        os.makedirs(chunk_dir, exist_ok=True)
        commands = []
        chunk_outputs = []
        for i, chunk in enumerate(chunks):
            list_file = os.path.join(
                chunk_dir, 'chunk_{:03d}_files.json'.format(i))
            ct_utils.write_json(list_file, chunk, force_str=True)
            out_file = os.path.join(
                chunk_dir, 'chunk_{:03d}_results.json'.format(i))
            chunk_outputs.append(out_file)
            cmd = ('python -m megadetector_tpu_torch.detection.'
                   'run_detector_batch {} {} {} --batch_size {} '
                   '--checkpoint_frequency {}'.format(
                       self.options.model_file, list_file, out_file,
                       self.options.batch_size,
                       self.options.checkpoint_frequency))
            if self.options.device is not None:
                cmd += ' --device {}'.format(self.options.device)
            if per_chunk_detector_options:
                cmd += ' --detector_options ' + ' '.join(
                    per_chunk_detector_options)
            commands.append(cmd)

        combine_cmd = ('python -m megadetector_tpu_torch.postprocessing.'
                       'combine_batch_outputs {} {}'.format(
                           ' '.join(chunk_outputs),
                           self.detections_file))
        script = os.path.join(chunk_dir, 'run_all_chunks.sh')
        with open(script, 'w') as f:
            f.write('#!/bin/bash\nset -e\n')
            for i, cmd in enumerate(commands):
                f.write('# chunk {} ({} images)\n{}\n'.format(
                    i, len(chunks[i]), cmd))
            f.write('# merge shards\n{}\n'.format(combine_cmd))
        os.chmod(script, 0o755)

        self.estimate_time()
        print('Wrote {} chunk lists + {}'.format(len(chunks), script))
        return script

    def estimate_time(self, images_per_second=None):
        """Print a wall-clock estimate for the detection stage. The
        default rate is the one this job's run_detector stage measured
        where it ran, else CARD_IMAGES_PER_SECOND (57.855 images/s:
        yolov5l6 in bf16 at 1280 px, batch 8, 8 loader threads, on an
        NVIDIA H100 80GB HBM3 at 700 W)."""

        if images_per_second is None:
            images_per_second = getattr(
                self, 'detection_images_per_second', CARD_IMAGES_PER_SECOND)
        if not hasattr(self, 'image_files'):
            self.enumerate_images()
        n = len(self.image_files)
        seconds = n / max(images_per_second, 1e-9)
        print('Estimated detection time for {} images: {:.1f} minutes '
              'at {:.0f} img/s'.format(n, seconds / 60.0,
                                       images_per_second))
        return seconds

    def audit_results(self):
        """
        Look for failed and missing images in the results (the
        reference's post-run audit, manage_local_batch.py:863-980);
        raises when failures exceed
        options.max_tolerable_failed_images (reference knob at :115,
        asserted at :925-927). Returns
        {'n_images', 'failures': [...], 'missing': [...]}.
        """

        with open(self.final_file) as f:
            data = json.load(f)
        result_files = {im['file'] for im in data['images']}
        failures = [im['file'] for im in data['images']
                    if im.get('failure')]
        if not hasattr(self, 'image_files'):
            self.enumerate_images()
        expected = {os.path.relpath(fn, self.options.input_path)
                    .replace('\\', '/') for fn in self.image_files}
        missing = sorted(expected - result_files)
        print('Audit: {} results, {} failures, {} missing'.format(
            len(result_files), len(failures), len(missing)))
        max_failures = self.options.max_tolerable_failed_images
        if max_failures is not None and len(failures) > max_failures:
            raise RuntimeError(
                '{} failures (max tolerable set to {})'.format(
                    len(failures), max_failures))
        return {'n_images': len(result_files), 'failures': failures,
                'missing': missing}

    def strip_nonanimal_classifications(self):
        """Remove classifications from person/vehicle detections
        (reference cell :1640)."""

        from megadetector_tpu_torch.postprocessing \
            .classification_postprocessing import \
            strip_classifications_from_nonanimal_detections
        strip_classifications_from_nonanimal_detections(
            self.final_file, self.final_file)

    def smooth_sequences(self, sequence_information=None):
        """Sequence-level classification smoothing (reference cells
        :1702-1880); [sequence_information] per
        classification_postprocessing's contract (defaults to the
        result of build_sequences())."""

        if sequence_information is None:
            sequence_information = getattr(
                self, 'sequence_information', None) or \
                self.build_sequences()
        from megadetector_tpu_torch.postprocessing \
            .classification_postprocessing import \
            smooth_classification_results_sequence_level
        smooth_classification_results_sequence_level(
            self.final_file, sequence_information, self.final_file,
            options=self._smoothing_options())

    def remove_unused_categories(self):
        """Drop classification categories with no remaining
        classifications (reference cell :1932)."""

        with open(self.final_file) as f:
            data = json.load(f)
        used = set()
        for im in data['images']:
            for det in im.get('detections') or []:
                for c in det.get('classifications') or []:
                    used.add(c[0])
        for key in ('classification_categories',
                    'classification_category_descriptions'):
            if key in data:
                data[key] = {k: v for k, v in data[key].items()
                             if k in used}
        ct_utils.write_json(self.final_file, data, force_str=True)
        return data

    def zip_results(self):
        """Zip the final results .json (reference cell :1953)."""

        import zipfile
        zip_path = self.final_file + '.zip'
        with zipfile.ZipFile(zip_path, 'w',
                             zipfile.ZIP_DEFLATED) as zf:
            zf.write(self.final_file,
                     os.path.basename(self.final_file))
        print('Wrote {}'.format(zip_path))
        return zip_path

    def build_interesting_preview(self, category_names,
                                  threshold=0.2):
        """Preview page restricted to images whose detections include
        any of [category_names] (reference cell :1971)."""

        with open(self.final_file) as f:
            data = json.load(f)
        name_to_id = {v: k for k, v in
                      data['detection_categories'].items()}
        wanted = {name_to_id[n] for n in category_names
                  if n in name_to_id}
        subset = {
            'info': data.get('info', {}),
            'detection_categories': data['detection_categories'],
            'images': [
                im for im in data['images']
                if any(d['category'] in wanted and
                       d['conf'] >= threshold
                       for d in im.get('detections') or [])],
        }
        for key in ('classification_categories',
                    'classification_category_descriptions'):
            if key in data:
                subset[key] = data[key]
        subset_file = os.path.join(self.job_dir,
                                   'interesting_subset.json')
        ct_utils.write_json(subset_file, subset, force_str=True)

        from megadetector_tpu_torch.postprocessing.postprocess_batch_results \
            import PostProcessingOptions, process_batch_results
        p_options = PostProcessingOptions()
        p_options.md_results_file = subset_file
        p_options.output_dir = os.path.join(self.job_dir,
                                            'preview_interesting')
        p_options.image_base_dir = self.options.input_path
        p_options.num_images_to_sample = \
            self.options.preview_sample_size
        return process_batch_results(p_options)

    def split_results_by_top_folder(self):
        """Split the final results into one file per top-level folder
        (reference cell :2037). Returns {folder: file}."""

        from megadetector_tpu_torch.postprocessing \
            .subset_json_detector_output import (
                SubsetJsonDetectorOutputOptions,
                subset_json_detector_output)
        options = SubsetJsonDetectorOutputOptions()
        options.split_folders = True
        options.split_folder_mode = 'top'
        out_dir = os.path.join(self.job_dir, 'splits')
        return subset_json_detector_output(self.final_file, out_dir,
                                           options)

    def build_sequences(self, max_gap_seconds=10.0, method=None):
        """
        Group this job's images into sequences (the reference's
        build-sequences cell, manage_local_batch.py:1702-1850). Method
        (default options.sequence_method):

        - 'exif': time-based sequences from EXIF datetimes, location =
          parent folder
        - 'folder': each leaf folder is one sequence (the
          frames-from-one-video convention, reference :1793-1833)
        - 'json': load a CCT-formatted file with
          seq_id/seq_num_frames/frame_num (options.cct_formatted_json,
          reference :1836-1849)

        Stores and returns the image-info list (usable directly by
        smooth_sequences()).
        """

        method = method or self.options.sequence_method

        from megadetector_tpu_torch.data_management.cct_json_utils import (
            SequenceOptions, create_sequences)
        from megadetector_tpu_torch.data_management.read_exif import \
            read_pil_exif
        from megadetector_tpu_torch.visualization import \
            visualization_utils as vis_utils

        with open(self.final_file) as f:
            data = json.load(f)

        if method == 'folder':
            image_info = [{'file_name': im['file'],
                           'seq_id': os.path.dirname(im['file'])
                           .replace('\\', '/') or 'root'}
                          for im in data['images']]
            self.sequence_information = image_info
            print('Extracted {} sequences from {} images'.format(
                len({im['seq_id'] for im in image_info}),
                len(image_info)))
            return image_info

        if method == 'json':
            assert self.options.cct_formatted_json is not None, \
                "sequence_method 'json' needs options.cct_formatted_json"
            with open(self.options.cct_formatted_json) as f:
                cct = json.load(f)
            for im in cct['images']:
                for field in ('seq_id', 'seq_num_frames', 'frame_num'):
                    assert field in im, \
                        'Image {} is missing field {}'.format(
                            im.get('file_name'), field)
            self.sequence_information = cct['images']
            return cct['images']

        assert method == 'exif', \
            'Unrecognized sequence method {}'.format(method)

        image_info = []
        for im in data['images']:
            fn = im['file']
            dt = im.get('datetime')
            if dt is None:
                try:
                    pil = vis_utils.open_image(os.path.join(
                        self.options.input_path, fn))
                    exif = read_pil_exif(pil) or {}
                    dt = exif.get('DateTimeOriginal',
                                  exif.get('DateTime'))
                except Exception:
                    dt = None
            image_info.append({
                'file_name': fn,
                'datetime': dt,
                'location': os.path.dirname(fn) or 'root',
            })

        seq_options = SequenceOptions()
        seq_options.episode_interval_seconds = max_gap_seconds
        create_sequences(image_info, seq_options)
        self.sequence_information = image_info
        n_seq = len({im.get('seq_id') for im in image_info})
        print('Assembled {} sequences from {} images'.format(
            n_seq, len(image_info)))
        return image_info

    def apply_custom_taxa(self, taxa_list, taxonomy_file,
                          allow_walk_down=False):
        """Restrict classifications to a custom taxa list (reference
        cells :1617,:1898); see
        classification_postprocessing.restrict_to_taxa_list."""

        from megadetector_tpu_torch.postprocessing \
            .classification_postprocessing import restrict_to_taxa_list
        restrict_to_taxa_list(taxa_list, taxonomy_file,
                              self.final_file, self.final_file,
                              allow_walk_down=allow_walk_down)

    def audit_classification_results(self, threshold=None):
        """
        Confirm the classification stage covered every above-threshold
        animal detection (reference cell :1555). Returns
        {'n_animal_detections', 'n_classified', 'unclassified_files'}.
        """

        if threshold is None:
            threshold = self.options.classification_confidence_threshold
        with open(self.final_file) as f:
            data = json.load(f)
        n_animal = n_classified = 0
        unclassified_files = set()
        for im in data['images']:
            for det in im.get('detections') or []:
                if det['category'] != '1' or det['conf'] < threshold:
                    continue
                n_animal += 1
                if det.get('classifications'):
                    n_classified += 1
                else:
                    unclassified_files.add(im['file'])
        print('Classification audit: {}/{} animal detections '
              'classified'.format(n_classified, n_animal))
        return {'n_animal_detections': n_animal,
                'n_classified': n_classified,
                'unclassified_files': sorted(unclassified_files)}

    def build_preview(self, stage=None):
        """
        Stage 5: HTML preview. With [stage], writes to a stage-suffixed
        folder so the reference's multi-point preview chain (pre-RDE,
        post-RDE, post-classification, post-smoothing — cells :980,
        :1101, :1601, :1687, :1880, :1914) keeps every preview.
        """

        from megadetector_tpu_torch.postprocessing.postprocess_batch_results \
            import PostProcessingOptions, process_batch_results
        p_options = PostProcessingOptions()
        p_options.md_results_file = self.final_file
        p_options.output_dir = self.preview_dir if stage is None else \
            '{}_{}'.format(self.preview_dir, stage)
        p_options.image_base_dir = self.options.input_path
        p_options.num_images_to_sample = \
            self.options.preview_sample_size
        return process_batch_results(p_options)

    def build_report(self):
        """Stage 6: CSV report."""

        from megadetector_tpu_torch.postprocessing.generate_csv_report import \
            generate_csv_report
        return generate_csv_report(self.final_file, self.report_file)

    def run_all(self):
        """All automated stages in order; returns the final results file."""

        self.enumerate_images()
        self.run_detector()
        self.validate()
        if self.options.preview_each_stage:
            self.build_preview(stage='pre_rde')
        self.run_rde()
        self.validate()
        if self.options.preview_each_stage and self.options.run_rde:
            self.build_preview(stage='post_rde')
        self.run_classifier()
        if self.options.preview_each_stage and \
                self.options.classifier_model is not None:
            self.build_preview(stage='post_classification')
        self.build_preview()
        self.build_report()
        print('Job {} complete; final results: {}'.format(
            self.options.job_name, self.final_file))
        return self.final_file


def main():
    import argparse
    import sys
    parser = argparse.ArgumentParser(
        description='Run the full batch workflow on a folder of images')
    parser.add_argument('input_path')
    parser.add_argument('output_base')
    parser.add_argument('--model_file', default='MDV5A')
    parser.add_argument('--job_name', default=None)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--no_rde', action='store_true')
    parser.add_argument('--detector_options', nargs='*', default=None)
    parser.add_argument('--device', default=None,
                        help='cuda, cuda:N or cpu (default: cuda, which '
                             'needs a card)')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    options = BatchJobOptions()
    options.input_path = args.input_path
    options.output_base = args.output_base
    options.model_file = args.model_file
    options.job_name = args.job_name
    options.batch_size = args.batch_size
    options.run_rde = not args.no_rde
    options.detector_options = ct_utils.parse_kvp_list(
        args.detector_options)
    options.device = args.device
    BatchJob(options).run_all()


if __name__ == '__main__':
    main()
