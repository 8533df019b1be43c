"""
Classification postprocessing: within-image and sequence-level label
smoothing, taxa-list restriction, and non-animal classification stripping.

Behavioral contract follows the reference
(megadetector/postprocessing/classification_postprocessing.py): image-level
smoothing (:839) expresses "an image with 700 cows and one deer is 701
cows" — when the dominant class has at least
min_detections_to_overwrite_secondary above-threshold classifications and
no other class exceeds max_detections_nondominant_class, flip everything
to the dominant class; 'other'-ish categories are overwritten more
aggressively (min_detections_to_overwrite_other); sequence-level smoothing
(:948) applies the same logic across a sequence; taxa restriction (:1182)
remaps predictions outside an allow-list; non-animal classification
stripping (:1119) removes classifications from person/vehicle detections.

The port's own copy of
megadetector_tpu/postprocessing/classification_postprocessing.py: the same
public names, signatures, defaults and output bytes.
"""

import argparse
import json
import sys

from collections import defaultdict

from megadetector_tpu_torch.utils import ct_utils


class ClassificationSmoothingOptions:
    """Options for image- and sequence-level smoothing."""

    def __init__(self):
        # Flip non-dominant classifications when the dominant class has at
        # least this many above-threshold detections...
        self.min_detections_to_overwrite_secondary = 4
        # ...and no other class has more than this many
        self.max_detections_nondominant_class = 1
        # 'Other'-ish categories get overwritten at a lower bar
        self.min_detections_to_overwrite_other = 2
        self.other_category_names = ['other', 'unknown', 'no cv result',
                                     'animal', 'blank', 'mammal']
        # Only classifications above this confidence participate
        self.classification_confidence_threshold = 0.5
        # Only detections above this confidence participate
        self.detection_confidence_threshold = 0.15
        # When classification_category_descriptions carry taxonomy
        # strings, propagate higher-level taxa down to more-specific
        # descendants that are more common in the group (reference:
        # classification_postprocessing.py:105-122 'carnivore/fox/fox'
        # -> 'fox/fox/fox'). Level vs count preference weights as in the
        # reference (count weight breaks ties by default).
        self.propagate_classifications_through_taxonomy = True
        self.taxonomy_propagation_level_weight = 1.0
        self.taxonomy_propagation_count_weight = 0.01
        # Within-family smoothing (reference:
        # classification_postprocessing.py:69-77,696-784): when the
        # dominant category is below-family level (genus/species) with
        # at least [min_detections_to_overwrite_secondary_same_family]
        # detections, flip same-family minority categories with at most
        # [max_detections_nondominant_class_same_family] detections to
        # it. The -1 default disables the rule (every count exceeds
        # -1), matching the reference; manage_local_batch's
        # allow_same_family_smoothing sets the max to 10000.
        self.min_detections_to_overwrite_secondary_same_family = 2
        self.max_detections_nondominant_class_same_family = -1


def _category_descriptions(data):
    """{category id: lower-cased name} for classification categories."""

    return {k: str(v).lower()
            for k, v in data.get('classification_categories', {}).items()}


def _top_classification(det, conf_threshold):
    """(category_id, conf) of the detection's top classification, or None."""

    classifications = det.get('classifications')
    if not classifications:
        return None
    top = classifications[0]
    if top[1] < conf_threshold:
        return None
    return top[0], top[1]


def _collect_class_counts(images, options):
    """Count above-threshold top classifications across [images]."""

    counts = defaultdict(int)
    for im in images:
        for det in im.get('detections') or []:
            if det['conf'] < options.detection_confidence_threshold:
                continue
            top = _top_classification(
                det, options.classification_confidence_threshold)
            if top is not None:
                counts[top[0]] += 1
    return counts


def count_detections_by_classification_category(detections,
                                                options=None):
    """
    {category id: count} of above-threshold top classifications on
    above-threshold detections, sorted descending by count
    (reference: classification_postprocessing.py:185-223).
    """

    if not detections:
        return {}
    if options is None:
        options = ClassificationSmoothingOptions()

    counts = defaultdict(int)
    for det in detections:
        if det['conf'] < options.detection_confidence_threshold:
            continue
        top = _top_classification(
            det, options.classification_confidence_threshold)
        if top is not None:
            counts[top[0]] += 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def get_classification_description_string(category_to_count,
                                          classification_descriptions):
    """
    Summarize image content, e.g. 'rabbit (4), human (1)', from a
    category->count dict and 7-token description strings
    (reference: classification_postprocessing.py:226-251).
    """

    category_strings = []
    for category_id, count in category_to_count.items():
        tokens = classification_descriptions[category_id].split(';')
        assert len(tokens) == 7
        category_name = tokens[-1] or 'undefined category'
        category_strings.append('{} ({})'.format(category_name, count))
    return ', '.join(category_strings)


def _flip_classifications(images, target_category, options,
                          category_names, only_other=False,
                          only_categories=None):
    """Flip qualifying detections' classifications to [target_category]."""

    n_changed = 0
    for im in images:
        for det in im.get('detections') or []:
            if det['conf'] < options.detection_confidence_threshold:
                continue
            top = _top_classification(
                det, options.classification_confidence_threshold)
            if top is None or top[0] == target_category:
                continue
            if only_other:
                name = category_names.get(top[0], '')
                if name not in options.other_category_names:
                    continue
            if only_categories is not None and \
                    top[0] not in only_categories:
                continue
            det['classifications'] = [[target_category, top[1]]]
            n_changed += 1
    return n_changed


def _taxonomy_prefix(desc):
    """7-part taxonomy string -> tuple of contiguous non-empty levels
    (class..species), or None for non-taxonomic names."""

    from megadetector_tpu_torch.postprocessing.classification_ensemble import (
        TAXONOMY_LEVELS, is_taxonomy_string, parse_taxonomy_string)

    if not is_taxonomy_string(desc):
        return None
    parsed = parse_taxonomy_string(desc)
    out = []
    for level in TAXONOMY_LEVELS:
        if parsed[level]:
            out.append(parsed[level].lower())
        else:
            break
    return tuple(out)


def _propagate_taxonomy(images, options, descriptions):
    """
    Propagate higher-level taxa down to more-specific descendants
    present in the same group ('carnivore/fox/fox' -> 'fox/fox/fox'):
    for each ancestor category with above-threshold counts, flip it to
    the descendant maximizing level_weight * specificity +
    count_weight * count (reference semantics:
    classification_postprocessing.py:105-122,383-794).
    """

    counts = _collect_class_counts(images, options)
    if len(counts) < 2:
        return 0
    prefixes = {c: _taxonomy_prefix(descriptions.get(c, ''))
                for c in counts}

    n_changed = 0
    for cat_a, prefix_a in prefixes.items():
        if not prefix_a:
            continue
        candidates = []
        for cat_d, prefix_d in prefixes.items():
            if cat_d == cat_a or not prefix_d:
                continue
            if len(prefix_d) > len(prefix_a) and \
                    prefix_d[:len(prefix_a)] == prefix_a:
                score = (options.taxonomy_propagation_level_weight *
                         len(prefix_d) +
                         options.taxonomy_propagation_count_weight *
                         counts[cat_d])
                candidates.append((score, cat_d))
        if candidates:
            best = max(candidates)[1]
            n_changed += _flip_classifications(
                images, best, options, {}, only_categories={cat_a})
    return n_changed


def _smooth_image_group(images, options, category_names,
                        descriptions=None):
    """Core smoothing rule applied to a group of images (1 or a sequence)."""

    n_propagated = 0
    if descriptions and options.propagate_classifications_through_taxonomy:
        n_propagated = _propagate_taxonomy(images, options, descriptions)

    counts = _collect_class_counts(images, options)
    if not counts:
        return n_propagated

    # Dominant class excluding 'other'-ish categories
    sorted_counts = sorted(counts.items(), key=lambda kv: -kv[1])
    non_other = [(c, n) for c, n in sorted_counts
                 if category_names.get(c, '') not in
                 options.other_category_names]
    if not non_other:
        return n_propagated
    dominant_category, dominant_count = non_other[0]

    n_changed = n_propagated

    # Aggressive 'other' overwrite
    if dominant_count >= options.min_detections_to_overwrite_other:
        n_changed += _flip_classifications(
            images, dominant_category, options, category_names,
            only_other=True)

    # Full overwrite when dominance is strong enough
    others = [n for c, n in counts.items()
              if c != dominant_category and
              category_names.get(c, '') not in
              options.other_category_names]
    max_nondominant = max(others, default=0)
    if dominant_count >= options.min_detections_to_overwrite_secondary \
            and max_nondominant <= options.max_detections_nondominant_class:
        n_changed += _flip_classifications(
            images, dominant_category, options, category_names)

    if descriptions:
        n_changed += _within_family_smoothing(images, options,
                                              category_names,
                                              descriptions)

    return n_changed


def _within_family_smoothing(images, options, category_names,
                             descriptions):
    """
    Flip same-family minority classifications to the dominant category
    (reference: classification_postprocessing.py:696-784): runs only
    when the dominant category is below-family level (genus/species)
    with >= min_detections_to_overwrite_secondary_same_family
    detections; a minority category flips when it has <=
    max_detections_nondominant_class_same_family detections (not a
    tie), shares the dominant's family, and is not a species being
    "flipped up" to its own genus.
    """

    if options.min_detections_to_overwrite_secondary_same_family <= 0 \
            or options.max_detections_nondominant_class_same_family < 1:
        return 0

    counts = _collect_class_counts(images, options)
    if len(counts) < 2:
        return 0
    sorted_counts = sorted(counts.items(), key=lambda kv: -kv[1])
    dominant_category, dominant_count = sorted_counts[0]
    if category_names.get(dominant_category, '') in \
            options.other_category_names:
        return 0
    if dominant_count < \
            options.min_detections_to_overwrite_secondary_same_family:
        return 0

    prefix_dom = _taxonomy_prefix(descriptions.get(dominant_category, ''))
    # Below-family level = genus or species present (class, order,
    # family, genus, ... -> prefix length > 3)
    if not prefix_dom or len(prefix_dom) <= 3:
        return 0
    family_dom = prefix_dom[2]
    genus_dom = prefix_dom[3] if len(prefix_dom) > 3 else ''

    flip_categories = set()
    for cat, count in counts.items():
        if cat == dominant_category:
            continue
        if count > options.max_detections_nondominant_class_same_family:
            continue
        if count == dominant_count:
            # Don't flip classes when it's a tie
            continue
        prefix = _taxonomy_prefix(descriptions.get(cat, ''))
        if not prefix or len(prefix) <= 2 or not prefix[2] or \
                not family_dom:
            continue
        if prefix[2] != family_dom:
            continue
        # Don't flip from a species up to the genus level in the same
        # genus (the dominant being the less specific of the two)
        genus = prefix[3] if len(prefix) > 3 else ''
        if genus == genus_dom and len(prefix) > len(prefix_dom):
            continue
        flip_categories.add(cat)

    if not flip_categories:
        return 0
    return _flip_classifications(images, dominant_category, options,
                                 category_names,
                                 only_categories=flip_categories)


def smooth_classification_results_image_level(input_file, output_file=None,
                                              options=None):
    """
    Smooth classifications within each image. [input_file] may be a path
    or an already-loaded dict. Returns the (modified) dict.
    """

    if options is None:
        options = ClassificationSmoothingOptions()

    if isinstance(input_file, str):
        with open(input_file) as f:
            data = json.load(f)
    else:
        data = input_file

    category_names = _category_descriptions(data)
    descriptions = data.get('classification_category_descriptions')
    n_changed = 0
    for im in data['images']:
        n_changed += _smooth_image_group([im], options, category_names,
                                         descriptions=descriptions)

    print('Image-level smoothing: changed {} classifications'.format(
        n_changed))
    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data


def smooth_classification_results_sequence_level(
        input_file, cct_sequence_information, output_file=None,
        options=None):
    """
    Smooth classifications across each sequence.
    [cct_sequence_information] is a CCT-style dict (or list of image
    dicts) whose images carry 'file_name' and 'seq_id' (see
    data_management.cct_json_utils.create_sequences), or a plain
    {filename: seq_id} mapping.
    """

    if options is None:
        options = ClassificationSmoothingOptions()

    if isinstance(input_file, str):
        with open(input_file) as f:
            data = json.load(f)
    else:
        data = input_file

    # Build filename -> sequence map
    if isinstance(cct_sequence_information, dict) and \
            'images' in cct_sequence_information:
        fn_to_seq = {im['file_name']: im.get('seq_id')
                     for im in cct_sequence_information['images']}
    elif isinstance(cct_sequence_information, list):
        fn_to_seq = {im['file_name']: im.get('seq_id')
                     for im in cct_sequence_information}
    else:
        fn_to_seq = dict(cct_sequence_information)

    seq_to_images = defaultdict(list)
    for im in data['images']:
        seq_id = fn_to_seq.get(im['file'])
        if seq_id is None:
            seq_id = '_unsequenced_{}'.format(im['file'])
        seq_to_images[seq_id].append(im)

    category_names = _category_descriptions(data)
    descriptions = data.get('classification_category_descriptions')
    n_changed = 0
    for seq_id, images in seq_to_images.items():
        n_changed += _smooth_image_group(images, options, category_names,
                                         descriptions=descriptions)

    print('Sequence-level smoothing: changed {} classifications'.format(
        n_changed))
    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data


def restrict_to_taxa_list(taxa_list, speciesnet_taxonomy_file,
                          input_file, output_file=None,
                          allow_walk_down=False):
    """
    Restrict classifications to an allow-list of category names.
    Predictions outside the list are remapped to an ancestor on the list
    when [speciesnet_taxonomy_file] provides a {name: parent chain}
    mapping ({child_name: [ancestor names...]} JSON), else dropped.
    With [allow_walk_down], a prediction that is itself an ancestor of
    exactly one on-list taxon maps DOWN to that taxon (e.g. a 'felidae'
    prediction becomes the only allowed felid species), matching the
    reference's unique-child walk-down
    (classification_postprocessing.py:1186,1668-1683).
    (Reference: classification_postprocessing.py:1182; the reference uses
    the WI taxonomy — here any parent-chain mapping works.)
    """

    if isinstance(taxa_list, str):
        with open(taxa_list) as f:
            taxa = set(line.strip().lower() for line in f
                       if len(line.strip()) > 0)
    else:
        taxa = set(t.lower() for t in taxa_list)

    parent_chains = {}
    if speciesnet_taxonomy_file is not None:
        with open(speciesnet_taxonomy_file) as f:
            parent_chains = {k.lower(): [p.lower() for p in v]
                             for k, v in json.load(f).items()}

    if isinstance(input_file, str):
        with open(input_file) as f:
            data = json.load(f)
    else:
        data = input_file

    categories = data.setdefault('classification_categories', {})
    name_to_id = {str(v).lower(): k for k, v in categories.items()}

    # ancestor name -> on-list taxa that have it in their parent chain
    # (used for the unique-child walk-down)
    ancestor_to_list_taxa = {}
    if allow_walk_down:
        for taxon, chain in parent_chains.items():
            if taxon not in taxa:
                continue
            for ancestor in chain:
                ancestor_to_list_taxa.setdefault(ancestor,
                                                 set()).add(taxon)

    def remap_category(cat_id):
        name = str(categories.get(cat_id, '')).lower()
        if name in taxa:
            return cat_id
        for ancestor in parent_chains.get(name, []):
            if ancestor in taxa and ancestor in name_to_id:
                return name_to_id[ancestor]
        if allow_walk_down:
            descendants = ancestor_to_list_taxa.get(name, set())
            if len(descendants) == 1:
                target = next(iter(descendants))
                if target not in name_to_id:
                    # The unique allowed descendant was never predicted;
                    # add it to the category scheme
                    new_id = str(1 + max(
                        [int(k) for k in categories] + [-1]))
                    categories[new_id] = target
                    name_to_id[target] = new_id
                return name_to_id[target]
        return None

    n_remapped = 0
    n_dropped = 0
    for im in data['images']:
        for det in im.get('detections') or []:
            classifications = det.get('classifications')
            if not classifications:
                continue
            new_classifications = []
            for c in classifications:
                new_id = remap_category(c[0])
                if new_id is None:
                    n_dropped += 1
                    continue
                if new_id != c[0]:
                    n_remapped += 1
                new_classifications.append([new_id] + list(c[1:]))
            det['classifications'] = new_classifications

    print('Taxa restriction: remapped {}, dropped {}'.format(
        n_remapped, n_dropped))
    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data


def strip_classifications_from_nonanimal_detections(
        input_file, output_file=None, animal_categories=('1',)):
    """
    Remove classifications from non-animal detections
    (reference: classification_postprocessing.py:1119).
    """

    if isinstance(input_file, str):
        with open(input_file) as f:
            data = json.load(f)
    else:
        data = input_file

    n_stripped = 0
    for im in data['images']:
        for det in im.get('detections') or []:
            if det['category'] not in animal_categories and \
                    det.get('classifications'):
                del det['classifications']
                n_stripped += 1

    print('Stripped classifications from {} non-animal detections'.format(
        n_stripped))
    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data


def remove_classifications_from_non_animal_detections(
        input_file, output_file, animal_category_names=None):
    """
    Remove classifications from non-animal detections in a MD .json
    file, optionally writing the results to a new .json file (reference:
    classification_postprocessing.py:1119-1136). Unlike
    strip_classifications_from_nonanimal_detections (which takes
    category IDs), [animal_category_names] is a list of detection
    category NAMES, defaulting to just 'animal'.
    """

    if animal_category_names is None:
        animal_category_names = ['animal']

    if isinstance(input_file, str):
        with open(input_file) as f:
            data = json.load(f)
    else:
        data = input_file

    animal_category_ids = tuple(
        cat_id for cat_id, name in
        data.get('detection_categories', {}).items()
        if name in animal_category_names)

    return strip_classifications_from_nonanimal_detections(
        data, output_file, animal_categories=animal_category_ids)


def _load_md(d):
    import copy
    if isinstance(d, dict):
        return copy.deepcopy(d)
    with open(d) as f:
        return json.load(f)


def merge_classification_categories(target_file, source_file,
                                    output_file=None):
    """
    Remap [source_file]'s classification category IDs to be compatible
    with [target_file]'s, by category NAME (reference:
    classification_postprocessing.py:1840). Source categories absent
    from the target get new IDs appended to the target scheme. Returns
    the remapped source dict.
    """

    target = _load_md(target_file)
    source = _load_md(source_file)

    t_cats = target.get('classification_categories')
    s_cats = source.get('classification_categories')
    if t_cats is None and s_cats is None:
        if output_file is not None:
            ct_utils.write_json(output_file, source, force_str=True)
        return source
    assert t_cats is not None and s_cats is not None, \
        'Exactly one input has classification categories'

    name_to_target_id = {str(v).lower(): k for k, v in t_cats.items()}
    merged = dict(t_cats)
    old_to_new = {}
    next_id = max([int(k) for k in merged] + [-1]) + 1
    for s_id, s_name in s_cats.items():
        key = str(s_name).lower()
        if key in name_to_target_id:
            old_to_new[s_id] = name_to_target_id[key]
        else:
            old_to_new[s_id] = str(next_id)
            merged[str(next_id)] = s_name
            name_to_target_id[key] = str(next_id)
            next_id += 1

    for im in source['images']:
        for det in im.get('detections') or []:
            for c in det.get('classifications') or []:
                c[0] = old_to_new.get(c[0], c[0])
    source['classification_categories'] = merged
    s_desc = source.get('classification_category_descriptions')
    if s_desc is not None:
        source['classification_category_descriptions'] = {
            old_to_new.get(k, k): v for k, v in s_desc.items()}

    if output_file is not None:
        ct_utils.write_json(output_file, source, force_str=True)
    return source


def combine_redundant_classification_categories(input_file,
                                                output_file=None):
    """
    Merge classification categories sharing the same name into one
    category (reference: classification_postprocessing.py:2042).
    Returns the remapped dict.
    """

    data = _load_md(input_file)
    cats = data.get('classification_categories', {})

    name_to_ids = defaultdict(list)
    for cat_id in sorted(cats, key=lambda k: int(k)):
        name_to_ids[str(cats[cat_id]).lower()].append(cat_id)

    old_to_new = {}
    new_cats = {}
    for name, ids in name_to_ids.items():
        keep = ids[0]
        new_cats[keep] = cats[keep]
        for cat_id in ids:
            old_to_new[cat_id] = keep

    n_merged = len(cats) - len(new_cats)
    for im in data['images']:
        for det in im.get('detections') or []:
            classifications = det.get('classifications')
            if not classifications:
                continue
            by_cat = {}
            for c in classifications:
                new_id = old_to_new.get(c[0], c[0])
                by_cat[new_id] = max(by_cat.get(new_id, 0.0), c[1])
            det['classifications'] = sorted(
                ([k, v] for k, v in by_cat.items()),
                key=lambda kv: -kv[1])

    data['classification_categories'] = new_cats
    desc = data.get('classification_category_descriptions')
    if desc is not None:
        data['classification_category_descriptions'] = {
            k: v for k, v in desc.items() if k in new_cats}
    print('Combined {} redundant classification categories'.format(
        n_merged))
    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data


def main():
    parser = argparse.ArgumentParser(
        description='Smooth classification results in an MD results file')
    parser.add_argument('input_file')
    parser.add_argument('output_file')
    parser.add_argument('--sequence_information', default=None,
                        help='CCT .json with seq_id fields (enables '
                             'sequence-level smoothing)')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    if args.sequence_information is not None:
        with open(args.sequence_information) as f:
            cct = json.load(f)
        smooth_classification_results_sequence_level(
            args.input_file, cct, args.output_file)
    else:
        smooth_classification_results_image_level(
            args.input_file, args.output_file)


if __name__ == '__main__':
    main()
