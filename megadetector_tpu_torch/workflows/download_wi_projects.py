"""
Operator workflow for bulk-processing Wildlife Insights project
downloads: after initiating .csv exports on the platform, unzip the
bundles under <base>/csv_downloads, then run the stages here to write
image-download scripts, verify download completion, clean redundant
thumbnails, convert labels to COCO (with sequences), preview, and
sample images for MD comparisons
(reference: notebooks/download_wi_projects.py:1-597).

Folder convention (reference: download_wi_projects.py:8-21):

    <base>/
      csv_downloads/
        wildlife-insights_<guid>_project-<id>_data/
          projects.csv, deployments.csv, images_<id>.csv ...
      images/
        <project_id>/   (created here)

Stages are resumable: each writes its outputs next to the project
folders and skips work whose outputs exist unless forced.

The port's own copy of megadetector_tpu/workflows/download_wi_projects.py:
the same public names, signatures, defaults and output bytes. No progress
bars: the card's machine is not promised tqdm.
"""

import argparse
import json
import os
import random
import shutil
import sys

from collections import defaultdict

from megadetector_tpu_torch.utils import path_utils
from megadetector_tpu_torch.utils.ct_utils import is_empty, write_json
from megadetector_tpu_torch.utils.wi_platform_utils import (
    read_images_from_download_bundle,
    url_to_relative_path,
    write_download_commands,
    write_prefix_download_command,
)


#%% Folder discovery


def find_project_download_folders(csv_base):
    """
    Map project IDs to bundle folder names under [csv_base]; bundle
    folders look like 'wildlife-insights_<guid>_project-<id>_data'
    (reference: download_wi_projects.py:86-106).
    """

    project_id_to_folder = {}
    for folder_name in sorted(os.listdir(csv_base)):
        if 'project-' not in folder_name or \
                not os.path.isdir(os.path.join(csv_base, folder_name)):
            continue
        project_id = int(
            folder_name.split('project-')[1].split('_')[0])
        assert project_id not in project_id_to_folder, \
            'Multiple bundles for project {}'.format(project_id)
        project_id_to_folder[project_id] = folder_name
    print('Found {} project bundles'.format(len(project_id_to_folder)))
    return project_id_to_folder


#%% Download-script preparation


def prepare_project_downloads(base_folder,
                              download_individual_images=False,
                              download_blank_images=True,
                              download_unidentified_images=True,
                              download_identified_images=True,
                              n_download_workers=25,
                              force=False):
    """
    For every project bundle: read its image records, filter by the
    identified/blank options, write image_records.json and gcloud
    download scripts under images/<project_id>, and cache per-project
    info to wi_project_info.json
    (reference: download_wi_projects.py:109-252).

    Whole-bucket (prefix) downloads can't skip categories of images, so
    the skip options require download_individual_images.

    Returns the list of project info dicts.
    """

    csv_base = os.path.join(base_folder, 'csv_downloads')
    image_base = os.path.join(base_folder, 'images')
    cache_file = os.path.join(base_folder, 'wi_project_info.json')

    if not download_individual_images:
        assert download_blank_images and download_unidentified_images \
            and download_identified_images, \
            "Can't skip image categories when downloading whole buckets"

    project_id_to_folder = find_project_download_folders(csv_base)
    projects = []

    for project_id, folder_name in project_id_to_folder.items():

        project_image_folder = os.path.join(image_base, str(project_id))
        # Individual-image mode writes its own master-script name
        # (write_download_commands' download_wi_images.sh)
        script_name = 'download_wi_images.sh' \
            if download_individual_images \
            else 'download_images_{}.sh'.format(project_id)
        download_command_file = os.path.join(project_image_folder,
                                             script_name)
        p = {'id': project_id,
             'project_download_folder': folder_name,
             'image_folder': project_image_folder}
        projects.append(p)

        if os.path.isfile(download_command_file) and not force:
            print('Download script for project {} exists, '
                  'skipping'.format(project_id))
            records_file = os.path.join(project_image_folder,
                                        'image_records.json')
            if os.path.isfile(records_file):
                with open(records_file) as f:
                    p['image_urls_to_download'] = \
                        [r['location'] for r in json.load(f)]
            continue

        bundle_folder = os.path.join(csv_base, folder_name)
        image_records = read_images_from_download_bundle(bundle_folder)
        records = []
        for x in image_records.values():
            records.extend(x)

        unidentified, skipped_identified, blanks, to_download = \
            [], [], [], []
        for r in records:
            identified_by = r['identified_by']
            if is_empty(identified_by) or \
                    str(identified_by).lower() == 'computer vision':
                unidentified.append(r)
                if download_unidentified_images:
                    to_download.append(r)
                continue
            if not download_identified_images:
                skipped_identified.append(r)
                continue
            is_blank = int(r['is_blank']) if r['is_blank'] != '' else 0
            common_name = r.get('common_name', '')
            if is_blank or (isinstance(common_name, str) and
                            common_name.lower() == 'blank'):
                blanks.append(r)
                if not download_blank_images:
                    continue
            to_download.append(r)

        print('Project {}: {} records, {} unidentified, {} blank, '
              '{} skipped-identified; downloading {}'.format(
                  project_id, len(records), len(unidentified),
                  len(blanks), len(skipped_identified),
                  len(to_download)))

        os.makedirs(project_image_folder, exist_ok=True)
        records_file = os.path.join(project_image_folder,
                                    'image_records.json')
        write_json(records_file, to_download, force_str=True)
        p['image_urls_to_download'] = [r['location']
                                       for r in to_download]

        if len(to_download) == 0:
            continue
        if download_individual_images:
            write_download_commands(
                to_download, project_image_folder,
                n_download_workers=n_download_workers)
        else:
            write_prefix_download_command(
                to_download, project_image_folder,
                download_command_file=download_command_file)

    write_json(cache_file, projects, force_str=True)
    print('Wrote project cache to {}'.format(cache_file))
    return projects


#%% Download completion audit


def check_download_completion(base_folder, projects=None):
    """
    Compare each project's requested URLs to files on disk; returns
    {project_id: {'matching': [...], 'missing': [...], 'extra': [...],
    'n_placeholders': N}} (reference: download_wi_projects.py:255-320).
    """

    image_base = os.path.join(base_folder, 'images')
    if projects is None:
        cache_file = os.path.join(base_folder, 'wi_project_info.json')
        with open(cache_file) as f:
            projects = json.load(f)

    # Local by-products of the download process aren't "extra files"
    ignore_tokens = ['download_wi_images', 'image_records',
                     'download_images_']

    report = {}
    for p in projects:
        project_id = p['id']
        folder = os.path.join(image_base, str(project_id))
        downloaded = set(path_utils.recursive_file_list(
            folder, return_relative_paths=True)) \
            if os.path.isdir(folder) else set()

        matching, missing, requested = [], [], set()
        n_placeholders = 0
        for url in p.get('image_urls_to_download', []):
            if 'placeholder' in url:
                n_placeholders += 1
                continue
            relative_path = url_to_relative_path(url)
            requested.add(relative_path)
            (matching if relative_path in downloaded
             else missing).append(relative_path)

        extra = [fn for fn in downloaded
                 if fn not in requested and
                 not any(tok in fn for tok in ignore_tokens)]

        print('Project {}: {} downloaded, {} matching, {} missing, '
              '{} placeholder, {} extra'.format(
                  project_id, len(downloaded), len(matching),
                  len(missing), n_placeholders, len(extra)))
        report[project_id] = {'matching': matching, 'missing': missing,
                              'extra': extra,
                              'n_placeholders': n_placeholders}
    return report


#%% Redundant-thumbnail cleanup


def find_redundant_thumbnails(base_folder):
    """
    Whole-bucket downloads include '_500' thumbnails alongside the
    originals; list the thumbnail paths whose original exists
    (reference: download_wi_projects.py:323-357).
    """

    image_base = os.path.join(base_folder, 'images')
    downloaded = set(path_utils.recursive_file_list(
        image_base, return_relative_paths=True))

    files_to_delete = []
    for relative_path in downloaded:
        if '_500' in relative_path and \
                relative_path.replace('_500', '') in downloaded:
            absolute_path = os.path.join(image_base, relative_path)
            assert os.path.isfile(absolute_path)
            files_to_delete.append(absolute_path)
    print('Identified {} redundant thumbnails (of {} files)'.format(
        len(files_to_delete), len(downloaded)))
    return files_to_delete


def delete_redundant_thumbnails(base_folder):
    """find_redundant_thumbnails + parallel delete; returns the list."""

    files_to_delete = find_redundant_thumbnails(base_folder)
    for fn in files_to_delete:
        assert '_500' in fn
    path_utils.parallel_delete_files(files_to_delete)
    return files_to_delete


#%% COCO conversion + sequences


def convert_projects_to_coco(base_folder, force=False,
                             image_flattening='deployment',
                             include_blanks=True):
    """
    Per project: bundle CSVs -> <id>.coco.json, then assemble EXIF-free
    sequences -> <id>.coco.with_sequences.json
    (reference: download_wi_projects.py:360-459). Returns the list of
    with-sequences COCO paths.
    """

    from megadetector_tpu_torch.data_management import cct_json_utils
    from megadetector_tpu_torch.data_management.wi_download_csv_to_coco \
        import wi_download_csv_to_coco

    csv_base = os.path.join(base_folder, 'csv_downloads')
    image_base = os.path.join(base_folder, 'images')
    project_id_to_folder = find_project_download_folders(csv_base)

    coco_files = []
    for project_id, folder_name in project_id_to_folder.items():
        project_image_folder = os.path.join(image_base, str(project_id))
        os.makedirs(project_image_folder, exist_ok=True)
        coco_file = os.path.join(project_image_folder,
                                 '{}.coco.json'.format(project_id))
        sequences_file = path_utils.insert_before_extension(
            coco_file, 'with_sequences')

        if not os.path.isfile(coco_file) or force:
            wi_download_csv_to_coco(
                csv_file_in=os.path.join(csv_base, folder_name),
                coco_file_out=coco_file,
                image_folder=project_image_folder,
                exclude_missing_images=False,
                image_flattening=image_flattening,
                blank_disagreement_handling='trust_label',
                include_blanks=include_blanks,
                verbose=True)

        if not os.path.isfile(sequences_file) or force:
            with open(coco_file) as f:
                d = json.load(f)
            cct_json_utils.create_sequences(d)
            write_json(sequences_file, d, force_str=True)
        coco_files.append(sequences_file)
    return coco_files


def preview_project_coco(base_folder, preview_base=None,
                         num_to_visualize=2000):
    """
    Render a visualize_db preview per project COCO file
    (reference: download_wi_projects.py:461-522). Returns the list of
    preview html paths.
    """

    from megadetector_tpu_torch.visualization.visualize_db import \
        DbVizOptions, visualize_db

    image_base = os.path.join(base_folder, 'images')
    if preview_base is None:
        preview_base = os.path.join(base_folder, 'coco-preview')
    os.makedirs(preview_base, exist_ok=True)

    preview_files = []
    for project_id in sorted(os.listdir(image_base)):
        project_image_folder = os.path.join(image_base, project_id)
        coco_file = os.path.join(
            project_image_folder,
            '{}.coco.with_sequences.json'.format(project_id))
        if not os.path.isfile(coco_file):
            continue
        viz_options = DbVizOptions()
        viz_options.num_to_visualize = num_to_visualize
        viz_options.random_seed = 0
        html_file = visualize_db(
            coco_file, os.path.join(preview_base, project_id),
            project_image_folder, options=viz_options)
        if isinstance(html_file, tuple):
            html_file = html_file[0]
        preview_files.append(html_file)
    return preview_files


#%% Cross-project image sampling


def sample_project_images(base_folder, sample_folder=None,
                          n_samples_per_project=50,
                          include_blanks_in_sample=False, seed=0):
    """
    Copy a random sample of (by default non-blank) images from each
    project into one flat folder for MD comparison runs
    (reference: download_wi_projects.py:525-597). Returns the copied
    paths.
    """

    image_base = os.path.join(base_folder, 'images')
    if sample_folder is None:
        sample_folder = os.path.join(base_folder, 'sample-images')
    os.makedirs(sample_folder, exist_ok=True)
    rng = random.Random(seed)

    to_copy = []
    for project_id in sorted(os.listdir(image_base)):
        project_image_folder = os.path.join(image_base, project_id)
        coco_file = os.path.join(
            project_image_folder,
            '{}.coco.with_sequences.json'.format(project_id))
        if not os.path.isfile(coco_file):
            continue
        with open(coco_file) as f:
            d = json.load(f)

        category_id_to_name = {c['id']: c['name']
                               for c in d['categories']}
        image_id_to_categories = defaultdict(set)
        for ann in d['annotations']:
            image_id_to_categories[ann['image_id']].add(
                category_id_to_name[ann['category_id']])

        candidates = []
        for im in d['images']:
            categories = image_id_to_categories[im['id']]
            if not include_blanks_in_sample and \
                    categories == {'empty'}:
                continue
            fn_abs = os.path.join(project_image_folder,
                                  im['file_name'])
            if os.path.isfile(fn_abs):
                candidates.append(fn_abs)

        n_sample = min(n_samples_per_project, len(candidates))
        sampled = rng.sample(candidates, n_sample)
        print('Project {}: sampled {} of {} candidates'.format(
            project_id, len(sampled), len(candidates)))
        to_copy.extend(sampled)

    copied = []
    seen_names = set()
    for fn_abs in to_copy:
        fn_out = os.path.basename(fn_abs)
        assert fn_out not in seen_names, \
            'Duplicate sample filename {}'.format(fn_out)
        seen_names.add(fn_out)
        target = os.path.join(sample_folder, fn_out)
        shutil.copyfile(fn_abs, target)
        copied.append(target)
    return copied


#%% CLI


def main():

    parser = argparse.ArgumentParser(
        description='Bulk-process Wildlife Insights project downloads: '
                    'write download scripts, audit completion, convert '
                    'to COCO, preview, and sample')
    parser.add_argument('base_folder',
                        help='folder containing csv_downloads/ with '
                             'unzipped WI export bundles')
    parser.add_argument('stage',
                        choices=['prepare', 'check', 'thumbnails',
                                 'coco', 'preview', 'sample'],
                        help='workflow stage to run')
    parser.add_argument('--download_individual_images',
                        action='store_true',
                        help='per-image gcloud commands instead of one '
                             'prefix download')
    parser.add_argument('--skip_blank_images', action='store_true')
    parser.add_argument('--skip_unidentified_images',
                        action='store_true')
    parser.add_argument('--skip_identified_images', action='store_true')
    parser.add_argument('--n_download_workers', type=int, default=25)
    parser.add_argument('--force', action='store_true',
                        help='regenerate outputs that already exist')
    parser.add_argument('--n_samples_per_project', type=int, default=50)
    parser.add_argument('--include_blanks_in_sample',
                        action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()

    if args.stage == 'prepare':
        prepare_project_downloads(
            args.base_folder,
            download_individual_images=args.download_individual_images,
            download_blank_images=not args.skip_blank_images,
            download_unidentified_images=
            not args.skip_unidentified_images,
            download_identified_images=not args.skip_identified_images,
            n_download_workers=args.n_download_workers,
            force=args.force)
    elif args.stage == 'check':
        check_download_completion(args.base_folder)
    elif args.stage == 'thumbnails':
        delete_redundant_thumbnails(args.base_folder)
    elif args.stage == 'coco':
        convert_projects_to_coco(args.base_folder, force=args.force)
    elif args.stage == 'preview':
        preview_project_coco(args.base_folder)
    elif args.stage == 'sample':
        sample_project_images(
            args.base_folder,
            n_samples_per_project=args.n_samples_per_project,
            include_blanks_in_sample=args.include_blanks_in_sample)


if __name__ == '__main__':
    main()
