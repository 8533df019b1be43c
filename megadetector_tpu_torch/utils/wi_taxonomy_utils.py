"""
Wildlife Insights / SpeciesNet taxonomy utilities (reference:
megadetector/utils/wi_taxonomy_utils.py): prediction-string parsing,
predictions.json <-> MD-format conversion, instances.json preparation,
prediction-file merging/validation, geofence-adjustment reporting, and a
TaxonomyHandler over a 7-part-string taxonomy table.

WI prediction strings are 7 semicolon-separated tokens:
"uuid;class;order;family;genus;species;common name". Semantic matching
here keys off the taxonomic tokens and common name, never the UUID.

The port's own copy of megadetector_tpu/utils/wi_taxonomy_utils.py:
the same public names, signatures, defaults and output bytes.
"""

import json
import os

from collections import defaultdict

from megadetector_tpu_torch.utils import ct_utils

TAXONOMY_LEVELS = ['class', 'order', 'family', 'genus', 'species']

# Well-known non-taxonomic prediction strings (UUIDs vary by taxonomy
# release; matching is by suffix tokens)
blank_prediction_string = \
    'f1856211-cfb7-4a5b-9158-c0f72fd09ee6;;;;;;blank'
no_cv_result_prediction_string = \
    'f2efdae9-efb8-48fb-8a91-eccf79ab4ffb;no cv result;;;;;no cv result'
animal_prediction_string = \
    '1f689929-883d-4dae-958c-3d57ab5b6c16;;;;;;animal'
human_prediction_string = ('990ae9dd-7a59-4344-afcb-1b7b21368000;'
                           'mammalia;primates;hominidae;homo;sapiens;'
                           'human')
vehicle_prediction_string = \
    'e2895ed5-780b-48f6-8a11-9e27cb594511;;;;;;vehicle'

current_format_version = '1.6'


#%% Prediction-string helpers


def is_valid_prediction_string(s):
    """A prediction string has exactly 7 semicolon-separated tokens and
    is lowercase."""

    return isinstance(s, str) and s.count(';') == 6 and s == s.lower()


def is_valid_taxonomy_string(s):
    """A taxonomy string is a prediction string without the UUID (6
    tokens: class;order;family;genus;species;common name)."""

    return isinstance(s, str) and s.count(';') == 5 and s == s.lower()


def is_valid_geofence_taxonomy_string(s):
    """Geofencing rules key off 5-token taxonomy strings
    (class;order;family;genus;species — the reference's 5-token
    is_valid_taxonomy_string, wi_taxonomy_utils.py:159)."""

    return isinstance(s, str) and s.count(';') == 4 and s == s.lower()


def get_common_name_from_prediction_string(s):
    """Last token of a prediction string."""

    tokens = s.split(';')
    assert len(tokens) == 7, 'Invalid prediction string {}'.format(s)
    return tokens[-1].strip()


def clean_taxonomy_string(s):
    """Strip the UUID from a 7-token prediction string (7 -> 6 tokens);
    passes 6-token strings through."""

    tokens = s.split(';')
    if len(tokens) == 7:
        return ';'.join(tokens[1:])
    assert len(tokens) == 6, 'Invalid taxonomy string {}'.format(s)
    return s


def taxonomy_level_to_string(k):
    """0 -> 'class', ..., 4 -> 'species' (5/6 map to non-taxonomic
    levels used for sorting)."""

    if 0 <= k < len(TAXONOMY_LEVELS):
        return TAXONOMY_LEVELS[k]
    raise ValueError('Invalid taxonomy level index {}'.format(k))


def taxonomy_level_string_to_index(s):
    return TAXONOMY_LEVELS.index(str(s).lower())


def taxonomy_level_index(s):
    """Index of the most specific non-empty level of a prediction or
    taxonomy string (-1 for non-taxonomic strings like 'blank')."""

    tokens = clean_taxonomy_string(s).split(';')[:5]
    level = -1
    for i, t in enumerate(tokens):
        if t.strip():
            level = i
    return level


def is_taxonomic_prediction_string(s):
    """True when at least one taxonomic token is non-empty."""

    return taxonomy_level_index(s) >= 0


def get_kingdom(prediction_string):
    """Rough kingdom inference: mammals/birds/reptiles/etc live in
    'animalia'; the class token is the best available signal."""

    tokens = clean_taxonomy_string(prediction_string).split(';')
    return 'animalia' if tokens[0].strip() else ''


def is_human_classification(prediction_string):
    s = prediction_string.lower()
    return ('homo;sapiens' in s or ';human' in s.rsplit(';', 1)[0] or
            s.endswith(';human') or 'homo species' in s)


def is_vehicle_classification(prediction_string):
    return prediction_string.lower().endswith(';vehicle')


def is_animal_classification(prediction_string):
    """Animal = taxonomic and not human, or the generic 'animal'."""

    s = prediction_string.lower()
    if s.endswith(';animal'):
        return True
    return is_taxonomic_prediction_string(s) and \
        not is_human_classification(s)


def taxonomy_info_to_taxonomy_string(taxonomy_info,
                                     include_taxon_id_and_common_name=False):
    """{'class': ..., 'order': ..., ...} -> taxonomy string."""

    tokens = [str(taxonomy_info.get(level, '') or '').lower()
              for level in TAXONOMY_LEVELS]
    if include_taxon_id_and_common_name:
        tokens = [str(taxonomy_info.get('taxon_id', ''))] + tokens + \
            [str(taxonomy_info.get('common_name', '')).lower()]
    return ';'.join(tokens)


#%% predictions.json <-> MD format


def generate_md_results_from_predictions_json(predictions_json_file,
                                              md_results_file=None,
                                              base_folder=None,
                                              convert_human_to_person=True,
                                              convert_homo_species_to_human=True,
                                              verbose=False):
    """
    Convert a SpeciesNet ensemble predictions.json file (or dict) to MD
    format (reference: wi_taxonomy_utils.py:504-779): detections copied
    with their categories, the whole-image 'prediction' (or top
    'classifications' entry) attached to every detection, fake
    whole-image detections created for non-blank images with no
    detections, categories mapped to common names with the 7-token
    strings kept in classification_category_descriptions.
    """

    if isinstance(predictions_json_file, str):
        with open(predictions_json_file) as f:
            predictions = json.load(f)
    else:
        predictions = dict(predictions_json_file)
    predictions = predictions['predictions']

    if base_folder is not None:
        base_folder = base_folder.replace('\\', '/')

    detection_categories = {}
    classification_string_to_id = {}
    fake_detections = []
    images_out = []
    n_base_replacements = 0

    for im_in in predictions:
        fn = im_in['filepath'].replace('\\', '/')
        if base_folder is not None:
            for prefix in (base_folder + '/', base_folder):
                if fn.startswith(prefix):
                    fn = fn[len(prefix):]
                    n_base_replacements += 1
                    break
        im_out = {'file': fn}

        if 'failures' in im_in and im_in['failures']:
            im_out['failure'] = str(im_in['failures'])
            im_out['detections'] = None
            images_out.append(im_out)
            continue

        im_out['detections'] = []
        for det_in in im_in.get('detections') or []:
            cat = str(det_in['category'])
            label = det_in.get('label', cat)
            if cat in detection_categories:
                assert detection_categories[cat] == label, \
                    'Inconsistent detection category {}'.format(cat)
            else:
                detection_categories[cat] = label
            im_out['detections'].append({
                'category': cat,
                'conf': det_in['conf'],
                'bbox': det_in['bbox'],
            })

        class_to_assign = None
        class_confidence = None
        top_common_name = None

        classifications = im_in.get('classifications')
        if classifications:
            assert len(classifications['scores']) == \
                len(classifications['classes'])
            class_to_assign = classifications['classes'][0]
            class_confidence = classifications['scores'][0]
            top_common_name = get_common_name_from_prediction_string(
                class_to_assign)

        if 'prediction' in im_in:
            im_out['top_classification_common_name'] = top_common_name
            class_to_assign = im_in['prediction']
            if convert_homo_species_to_human and \
                    ('hominidae;homo' in class_to_assign or
                     'homo species' in class_to_assign):
                class_to_assign = human_prediction_string
            class_confidence = im_in['prediction_score']

        if class_to_assign is not None:
            if class_to_assign != blank_prediction_string and \
                    len(im_out['detections']) == 0:
                if verbose:
                    print('Creating fake whole-image detection '
                          'for {}'.format(fn))
                det_out = {'category': 'unknown',
                           'conf': class_confidence,
                           'bbox': [0, 0, 1, 1]}
                fake_detections.append(det_out)
                im_out['detections'].append(det_out)
            if class_to_assign not in classification_string_to_id:
                classification_string_to_id[class_to_assign] = \
                    str(len(classification_string_to_id))
            cat_id = classification_string_to_id[class_to_assign]
            for det in im_out['detections']:
                det['classifications'] = [[cat_id, class_confidence]]

        images_out.append(im_out)

    if base_folder is not None and n_base_replacements == 0:
        print('Warning: base folder {} never matched'.format(
            base_folder))

    if fake_detections:
        existing = [int(k) for k in detection_categories] or [-1]
        fake_id = str(max(existing) + 1)
        detection_categories[fake_id] = 'unknown'
        for det in fake_detections:
            det['category'] = fake_id

    images_out = ct_utils.sort_list_of_dicts_by_key(images_out, 'file')

    descriptions = {v: k for k, v in
                    classification_string_to_id.items()}
    classification_categories = {
        cat_id: get_common_name_from_prediction_string(s)
        for cat_id, s in descriptions.items()}

    if convert_human_to_person:
        for k, v in detection_categories.items():
            if v == 'human':
                detection_categories[k] = 'person'

    output = {
        'info': {'format_version': current_format_version,
                 'detector': 'converted_from_predictions_json'},
        'detection_categories': detection_categories,
        'classification_categories': classification_categories,
        'classification_category_descriptions': descriptions,
        'images': images_out,
    }

    if md_results_file is not None:
        ct_utils.write_json(md_results_file, output, force_str=True)
        from megadetector_tpu_torch.postprocessing.validate_batch_results \
            import ValidateBatchResultsOptions, validate_batch_results
        v = ValidateBatchResultsOptions()
        v.raise_errors = True
        validate_batch_results(md_results_file, v)
    return output


def generate_predictions_json_from_md_results(md_results_file,
                                              predictions_json_file=None,
                                              base_folder=None):
    """
    MD results -> SpeciesNet predictions.json (detections only, for
    feeding the WI classifier; reference: wi_taxonomy_utils.py:782).
    """

    if isinstance(md_results_file, str):
        with open(md_results_file) as f:
            data = json.load(f)
    else:
        data = md_results_file

    categories = data.get('detection_categories', {})
    predictions = []
    for im in data['images']:
        fn = im['file']
        if base_folder is not None:
            fn = os.path.join(base_folder, fn).replace('\\', '/')
        p = {'filepath': fn}
        if im.get('failure'):
            p['failures'] = [im['failure']]
        else:
            p['detections'] = [{
                'category': det['category'],
                'label': categories.get(det['category'],
                                        det['category']),
                'conf': det['conf'],
                'bbox': det['bbox'],
            } for det in im.get('detections') or []]
        predictions.append(p)

    output = {'predictions': predictions}
    if predictions_json_file is not None:
        ct_utils.write_json(predictions_json_file, output,
                            force_str=True)
    return output


#%% instances.json / prediction-file plumbing


def generate_instances_json_from_folder(folder, country=None,
                                        admin1_region=None,
                                        output_file=None,
                                        recursive=True):
    """
    Build a SpeciesNet instances.json ({'instances': [{'filepath': ...,
    'country': ..., 'admin1_region': ...}]}) from an image folder
    (reference: wi_taxonomy_utils.py:854).
    """

    from megadetector_tpu_torch.utils.path_utils import find_images

    images = find_images(folder, recursive=recursive)
    instances = []
    for fn in images:
        inst = {'filepath': fn.replace('\\', '/')}
        if country is not None:
            inst['country'] = country
        if admin1_region is not None:
            inst['admin1_region'] = admin1_region
        instances.append(inst)
    output = {'instances': instances}
    if output_file is not None:
        ct_utils.write_json(output_file, output, force_str=True)
    return output


def split_instances_into_n_batches(instances_json, n_batches,
                                   output_files=None):
    """Split an instances dict/file into N batch files (reference:
    wi_taxonomy_utils.py:932). Returns the list of output files."""

    if isinstance(instances_json, str):
        with open(instances_json) as f:
            data = json.load(f)
        base = os.path.splitext(instances_json)[0]
    else:
        data = instances_json
        base = 'instances'

    instances = data['instances']
    if output_files is None:
        output_files = ['{}_batch_{:03d}.json'.format(base, i)
                        for i in range(n_batches)]
    assert len(output_files) == n_batches

    for i, output_file in enumerate(output_files):
        ct_utils.write_json(
            output_file, {'instances': instances[i::n_batches]},
            force_str=True)
    return output_files


def merge_prediction_json_files(input_prediction_files,
                                output_prediction_file=None):
    """Merge predictions.json shards, asserting filepath uniqueness
    (reference: wi_taxonomy_utils.py:977)."""

    merged = []
    seen = set()
    for fn in input_prediction_files:
        with open(fn) as f:
            shard = json.load(f)
        for p in shard['predictions']:
            assert p['filepath'] not in seen, \
                'Duplicate filepath {}'.format(p['filepath'])
            seen.add(p['filepath'])
            merged.append(p)
    output = {'predictions': merged}
    if output_prediction_file is not None:
        ct_utils.write_json(output_prediction_file, output,
                            force_str=True)
    return output


def load_md_or_speciesnet_file(fn, verbose=False):
    """
    Load either an MD-format file or a predictions.json file, always
    returning MD format (reference: wi_taxonomy_utils.py:1014).
    """

    with open(fn) as f:
        data = json.load(f)
    if 'images' in data:
        return data
    assert 'predictions' in data, \
        '{} is neither MD format nor predictions.json'.format(fn)
    if verbose:
        print('Converting predictions.json {} to MD format'.format(fn))
    return generate_md_results_from_predictions_json(data)


def validate_predictions_file(fn, instances=None):
    """
    Sanity-check a predictions.json file (reference:
    wi_taxonomy_utils.py:1050): structure, score ordering, and (when
    [instances] is given) coverage. Returns the loaded dict.
    """

    with open(fn) as f:
        data = json.load(f)
    assert 'predictions' in data, 'Missing predictions key'
    filepaths = set()
    for p in data['predictions']:
        assert 'filepath' in p, 'Prediction missing filepath'
        filepaths.add(p['filepath'])
        c = p.get('classifications')
        if c is not None:
            assert len(c['classes']) == len(c['scores'])
            assert all(c['scores'][i] >= c['scores'][i + 1]
                       for i in range(len(c['scores']) - 1)), \
                'Unsorted classification scores in {}'.format(
                    p['filepath'])
        for det in p.get('detections') or []:
            assert 0 <= det['conf'] <= 1
    if instances is not None:
        if isinstance(instances, str):
            with open(instances) as f:
                instances = json.load(f)
        expected = {i['filepath'] for i in instances['instances']}
        missing = expected - filepaths
        assert not missing, \
            '{} instances missing from predictions'.format(len(missing))
    return data


def find_geofence_adjustments(ensemble_json_file, use_latin_names=False):
    """
    Count classifications changed by geofencing in an ensemble
    predictions.json file, via the 'classifications' (pre-geofence) vs
    'prediction' (post-ensemble) fields (reference:
    wi_taxonomy_utils.py:1113). Returns {'pre -> post': count} sorted
    descending.
    """

    if isinstance(ensemble_json_file, str):
        with open(ensemble_json_file) as f:
            data = json.load(f)
    else:
        data = ensemble_json_file

    rollup_pair_to_count = defaultdict(int)
    for p in data['predictions']:
        c = p.get('classifications')
        pred = p.get('prediction')
        if not c or pred is None:
            continue
        top = c['classes'][0]
        if top == pred:
            continue

        def name(s):
            if use_latin_names:
                tokens = clean_taxonomy_string(s).split(';')
                latin = ' '.join(t for t in tokens[3:5] if t).strip()
                return latin or tokens[0] or s
            return get_common_name_from_prediction_string(s)

        rollup_pair_to_count['{} -> {}'.format(name(top),
                                               name(pred))] += 1

    return dict(sorted(rollup_pair_to_count.items(),
                       key=lambda kv: -kv[1]))


def generate_whole_image_detections_for_classifications(
        classifications_json_file, detections_json_file,
        ensemble_json_file=None, ignore_blank_classifications=True,
        verbose=True):
    """
    For classifier results that ran on pre-cropped images: write a
    SpeciesNet-format detections file where every image gets one
    whole-image detection whose category comes from its top
    classification, plus optionally a fake ensemble file carrying the
    classifications (reference: wi_taxonomy_utils.py:393-500). Returns
    the validation summary of the detections file.
    """

    if isinstance(classifications_json_file, str):
        with open(classifications_json_file) as f:
            classification_results = json.load(f)
    else:
        classification_results = classifications_json_file
    predictions = classification_results['predictions']

    output_predictions = []
    ensemble_predictions = []

    for i_prediction, prediction in enumerate(predictions):
        classes = prediction['classifications']['classes']
        scores = prediction['classifications']['scores']
        i_score = 0
        if ignore_blank_classifications:
            while classes[i_score] in (blank_prediction_string,
                                       no_cv_result_prediction_string):
                i_score += 1
                if i_score >= len(classes):
                    if verbose:
                        print('Ignoring blank classifications, but '
                              'image {} has no non-blank '
                              'values'.format(i_prediction))
                    i_score = 0
                    break

        top_classification = classes[i_score]
        if is_animal_classification(top_classification):
            category_name = 'animal'
        elif is_human_classification(top_classification):
            category_name = 'human'
        else:
            category_name = 'vehicle'
        md_category_name = 'person' if category_name == 'human' \
            else category_name
        from megadetector_tpu_torch.detection.run_detector import \
            DEFAULT_DETECTOR_LABEL_MAP
        md_category_id = {v: k for k, v in
                          DEFAULT_DETECTOR_LABEL_MAP.items()}[
                              md_category_name]

        output_detection = {
            'label': category_name,
            'category': md_category_id,
            'conf': 1.0,
            'bbox': [0.0, 0.0, 1.0, 1.0],
        }
        output_predictions.append({
            'filepath': prediction['filepath'],
            'detections': [output_detection],
        })
        ensemble_predictions.append({
            'filepath': prediction['filepath'],
            'detections': [output_detection],
            'prediction': top_classification,
            'prediction_score': scores[i_score],
            'prediction_source': 'fake_ensemble_file_utility',
            'classifications': prediction['classifications'],
        })

    if ensemble_json_file is not None:
        with open(ensemble_json_file, 'w') as f:
            json.dump({'predictions': ensemble_predictions}, f,
                      indent=1)
        validate_predictions_file(ensemble_json_file)

    with open(detections_json_file, 'w') as f:
        json.dump({'predictions': output_predictions}, f, indent=1)
    return validate_predictions_file(detections_json_file)


def generate_geofence_adjustment_html_summary(rollup_pair_to_count,
                                              min_count=10):
    """
    HTML fragment (a <div>, not a full page) summarizing geofence
    rollup changes with at least [min_count] occurrences;
    rollup_pair_to_count comes from find_geofence_adjustments
    (reference: wi_taxonomy_utils.py:1187-1229).
    """

    rollup_pair_to_count = {k: v for k, v in
                            rollup_pair_to_count.items()
                            if v >= min_count}
    counts = list(rollup_pair_to_count.values())
    assert counts == sorted(counts, reverse=True), \
        'rollup_pair_to_count must be sorted descending by count'

    if len(rollup_pair_to_count) == 0:
        return ''

    footer = ('<h3>Geofence changes that occurred more than {} '
              'times</h3>\n'.format(min_count))
    footer += '<div class="contentdiv">\n'
    for rollup_pair, count in rollup_pair_to_count.items():
        footer += '{} ({})<br/>\n'.format(
            rollup_pair.replace(',', ' &rarr; '), count)
    footer += '</div>\n'
    return footer


#%% TaxonomyHandler


class TaxonomyHandler:
    """
    Lookup over a WI taxonomy release: maps common names and latin
    names to full 7-token prediction strings, and walks parent chains
    by truncating taxonomy levels (reference:
    wi_taxonomy_utils.py:1232).

    The taxonomy source is a text file with one prediction string per
    line (or a list of strings).
    """

    def __init__(self, taxonomy_source, geofencing_file=None,
                 country_code_file=None):
        if isinstance(taxonomy_source, str):
            with open(taxonomy_source) as f:
                lines = [line.strip() for line in f if line.strip()]
        else:
            lines = list(taxonomy_source)

        self.prediction_strings = []
        self.common_name_to_string = {}
        self.latin_name_to_string = {}
        #: 5-token taxonomy string -> taxonomy info dict (reference:
        #: wi_taxonomy_utils.py:_load_taxonomy_info)
        self.taxonomy_string_to_taxonomy_info = {}
        self.binomial_name_to_taxonomy_info = {}
        self.common_name_to_taxonomy_info = {}
        #: Geofencing state; populated by initialize_geofencing
        self.taxonomy_string_to_geofencing_rules = None
        self.country_to_country_code = None
        self.country_code_to_country = None

        for s in lines:
            s = s.strip().lower()
            if s.count(';') == 5:
                s = ';' + s  # tolerate uuid-less releases
            if not is_valid_prediction_string(s):
                continue
            self.prediction_strings.append(s)
            tokens = s.split(';')
            common = tokens[6].strip()
            if common:
                self.common_name_to_string.setdefault(common, s)
            genus, species = tokens[4].strip(), tokens[5].strip()
            if genus and species:
                self.latin_name_to_string.setdefault(
                    '{} {}'.format(genus, species), s)
            elif genus:
                self.latin_name_to_string.setdefault(genus, s)

            info = {
                'taxon_id': tokens[0],
                'kingdom': 'animal',
                'phylum': 'chordata',
                'class': tokens[1],
                'order': tokens[2],
                'family': tokens[3],
                'genus': genus,
                'species': species,
                'common_name': common,
            }
            five_token = ';'.join(tokens[1:6])
            self.taxonomy_string_to_taxonomy_info.setdefault(
                five_token, info)
            if common:
                self.common_name_to_taxonomy_info.setdefault(common,
                                                             info)
            # Binomial name: most specific non-empty taxon (subspecies
            # keep their space, e.g. "canis;lupus dingo")
            binomial = None
            if genus and species:
                binomial = '{} {}'.format(genus, species)
            else:
                for t in (tokens[4], tokens[3], tokens[2], tokens[1]):
                    if t.strip():
                        binomial = t.strip()
                        break
            if binomial:
                self.binomial_name_to_taxonomy_info.setdefault(binomial,
                                                               info)

        if geofencing_file is not None:
            assert country_code_file is not None, \
                'Geofencing requires a country-code file'
            self.initialize_geofencing(geofencing_file,
                                       country_code_file)

    def string_for_name(self, name):
        """Prediction string for a common or latin name (or None)."""

        name = str(name).strip().lower()
        return self.common_name_to_string.get(
            name, self.latin_name_to_string.get(name))

    def parent_string(self, prediction_string):
        """Prediction string truncated one taxonomy level up (None at
        the top)."""

        tokens = prediction_string.split(';')
        assert len(tokens) == 7
        level = taxonomy_level_index(prediction_string)
        if level <= 0:
            return None
        tokens[1 + level] = ''
        tokens[6] = tokens[level]  # common name = taxon name
        return ';'.join(tokens[:1] + tokens[1:6] + [tokens[level]])

    def ancestor_chain(self, prediction_string):
        """List of ancestor prediction strings, nearest first."""

        out = []
        cur = self.parent_string(prediction_string)
        while cur is not None:
            out.append(cur)
            cur = self.parent_string(cur)
        return out

    #%% Geofencing (reference: wi_taxonomy_utils.py:1232-1911)
    #
    # Geofencing rules are keyed by five-token taxonomy strings
    # ('mammalia;cetartiodactyla;cervidae;odocoileus;virginianus') and
    # map 'allow'/'block' to {COUNTRY_CODE: [state codes]}; an empty
    # state list applies to the whole country, and state-level rules
    # currently exist only for the USA. Block rules win over allow
    # rules; a species with allow rules is blocked everywhere not
    # listed.

    def initialize_geofencing(self, geofencing_file, country_code_file):
        """
        Load geofencing rules (.json) and ISO-3166 country-code
        mappings (.csv with 'name' and 'alpha-3' columns).
        """

        import pandas as pd

        country_code_df = pd.read_csv(country_code_file)
        self.country_to_country_code = {}
        self.country_code_to_country = {}
        for _, row in country_code_df.iterrows():
            self.country_to_country_code[row['name'].lower()] = \
                row['alpha-3'].upper()
            self.country_code_to_country[row['alpha-3'].upper()] = \
                row['name'].lower()

        with open(geofencing_file, encoding='utf-8') as f:
            self.taxonomy_string_to_geofencing_rules = json.load(f)

        for species_string, species_rules in \
                self.taxonomy_string_to_geofencing_rules.items():
            if len(species_rules.keys()) > 1:
                print('Warning: taxon {} has both allow and block '
                      'rules'.format(species_string))
            for rule_type, country_rules in species_rules.items():
                assert rule_type in ('allow', 'block')
                for country_code, region_rules in country_rules.items():
                    assert country_code in self.country_code_to_country
                    if len(region_rules) > 0:
                        assert country_code == 'USA', \
                            'State-level rules only exist for the USA'

    def _parse_region_code_list(self, codes):
        """Country/state codes as a string, comma-delimited string, or
        list -> normalized uppercase list."""

        if not isinstance(codes, list):
            assert isinstance(codes, str)
            codes = [c for c in codes.strip().split(',')]
        codes = [c.upper().strip() for c in codes]
        for c in codes:
            assert len(c) in (2, 3), 'Illegal region code {}'.format(c)
        return codes

    def species_string_to_canonical_species_string(self, species):
        """
        Normalize a 5-token taxonomy string, 7-token prediction string,
        binomial name, or common name to a 5-token taxonomy string.
        Raises ValueError when the name is unknown.
        """

        species = str(species).lower().strip()
        n_tokens = len(species.split(';'))
        if n_tokens == 5:
            return species
        if n_tokens == 7:
            return ';'.join(species.split(';')[1:6])
        info = self.common_name_to_taxonomy_info.get(
            species, self.binomial_name_to_taxonomy_info.get(species))
        if info is None:
            raise ValueError(
                'Could not find taxonomic information for '
                '{}'.format(species))
        return ';'.join([info['class'], info['order'], info['family'],
                         info['genus'], info['species']])

    def species_string_to_taxonomy_info(self, species):
        """Taxonomy info dict for a species string/binomial/common
        name; raises ValueError when unknown."""

        canonical = self.species_string_to_canonical_species_string(
            species)
        if canonical not in self.taxonomy_string_to_taxonomy_info:
            raise ValueError(
                'Could not find taxonomic information for '
                '{}'.format(species))
        return self.taxonomy_string_to_taxonomy_info[canonical]

    def generate_csv_rows_for_species(self, species_string,
                                      allow_countries=None,
                                      block_countries=None,
                                      allow_states=None,
                                      block_states=None):
        """
        Rows in geofence_fixes.csv format
        ('species,allow|block,COUNTRY,STATE') for the given allow/block
        country and US-state lists. Performs no consistency checking
        between the allow and block lists.
        """

        assert is_valid_geofence_taxonomy_string(species_string), \
            '{} is not a valid taxonomy string'.format(species_string)

        lines = []
        if allow_countries is not None:
            for country in self._parse_region_code_list(allow_countries):
                lines.append(species_string + ',allow,' + country + ',')
        if block_countries is not None:
            for country in self._parse_region_code_list(block_countries):
                lines.append(species_string + ',block,' + country + ',')
        if allow_states is not None:
            for state in self._parse_region_code_list(allow_states):
                lines.append(species_string + ',allow,USA,' + state)
        if block_states is not None:
            for state in self._parse_region_code_list(block_states):
                lines.append(species_string + ',block,USA,' + state)
        return lines

    def generate_csv_rows_to_block_all_countries_except(
            self, species_string, block_except_list):
        """
        geofence_fixes.csv rows that block every country currently
        allowed for [species_string] except [block_except_list], and
        allow the listed countries that aren't already allowed. Raises
        ValueError when asked to allow an already-blocked country.
        """

        assert is_valid_geofence_taxonomy_string(species_string), \
            '{} is not a valid taxonomy string'.format(species_string)
        assert self.taxonomy_string_to_geofencing_rules is not None, \
            'Initialize geofencing prior to species lookup'

        rules = self.taxonomy_string_to_geofencing_rules[species_string]
        allowed_countries = list(rules.get('allow', {}))
        blocked_countries = list(rules.get('block', {}))
        block_except_list = self._parse_region_code_list(
            block_except_list)

        countries_to_block = [
            c for c in allowed_countries
            if c not in block_except_list and c not in blocked_countries]
        countries_to_allow = []
        for country in block_except_list:
            if country in blocked_countries:
                raise ValueError(
                    "Can't allow a country that has already been "
                    "blocked")
            if country not in allowed_countries:
                countries_to_allow.append(country)

        return self.generate_csv_rows_for_species(
            species_string, allow_countries=countries_to_allow,
            block_countries=countries_to_block)

    def species_allowed_in_country(self, species, country, state=None,
                                   return_status=False):
        """
        Whether [species] (common name, binomial name, or taxonomy
        string) is allowed in [country] (name or alpha-3 code) under
        the loaded geofencing rules. With return_status, returns the
        detailed status string ('allowed', 'blocked',
        'allow_by_default', 'block_usa_wide', ...) instead of a bool.
        """

        assert self.taxonomy_string_to_geofencing_rules is not None, \
            'Initialize geofencing prior to species lookup'

        taxonomy_string = \
            self.species_string_to_canonical_species_string(species)

        if state is not None:
            state = state.upper()
            assert len(state) == 2

        if len(country) == 3:
            assert country.upper() in self.country_code_to_country, \
                'Unknown country code {}'.format(country)
            country_code = country.upper()
        else:
            assert country.lower() in self.country_to_country_code, \
                'Unknown country {}'.format(country)
            country_code = self.country_to_country_code[country.lower()]

        # Species with no rules are allowed everywhere
        if taxonomy_string not in \
                self.taxonomy_string_to_geofencing_rules:
            return 'allow_by_default' if return_status else True

        rules = self.taxonomy_string_to_geofencing_rules[
            taxonomy_string]
        blocked_countries = list(rules.get('block', {}))
        allowed_countries = list(rules.get('allow', {}))

        # Block rules win over allow rules; an allow list blocks every
        # country not on it
        if country_code in blocked_countries:
            status = 'blocked_over_allow' \
                if country_code in allowed_countries else 'blocked'
        elif country_code in allowed_countries:
            status = 'allowed'
        elif len(allowed_countries) > 0:
            status = 'block_not_on_country_allow_list'
        else:
            assert len(blocked_countries) > 0
            status = 'allow_not_on_block_list'

        # State-level rules (USA only)
        if country_code == 'USA':
            usa_blocked = usa_allowed = False
            state_blocked = state_allowed = False
            other_states_blocked = other_states_allowed = False

            for rule_type in ('block', 'allow'):
                if rule_type not in rules or \
                        country_code not in rules[rule_type]:
                    continue
                state_list = rules[rule_type][country_code]
                if len(state_list) == 0:
                    # Country-wide rule
                    if rule_type == 'block':
                        usa_blocked = True
                    else:
                        usa_allowed = True
                elif state is not None:
                    if state in state_list:
                        if rule_type == 'block':
                            state_blocked = True
                        else:
                            state_allowed = True
                    else:
                        if rule_type == 'block':
                            other_states_blocked = True
                        else:
                            other_states_allowed = True
                else:
                    # State list but no state given: treat as allowing
                    # the whole country
                    usa_allowed = True

            if usa_blocked:
                status = 'block_usa_wide'
            elif usa_allowed:
                status = 'allow_usa_wide'
            elif state_blocked:
                status = 'block_by_state'
            elif state_allowed:
                status = 'allow_by_state'
            elif other_states_blocked:
                status = 'allow_other_states_blocked'
            elif other_states_allowed:
                status = 'block_other_states_allowed'

        if return_status:
            return status
        assert status.startswith(('allow', 'block'))
        return status.startswith('allow')

    def export_geofence_data_to_csv(self, csv_fn=None,
                                    include_common_names=True):
        """
        Geofencing rules as a dataframe with one taxon per row and one
        region (COUNTRY or USA:STATE) per column; 1 = allowed, empty =
        not allowed. Optionally written to [csv_fn].
        """

        import pandas as pd

        assert self.taxonomy_string_to_geofencing_rules is not None, \
            'Initialize geofencing prior to export'

        all_taxa = sorted(self.taxonomy_string_to_geofencing_rules)
        all_regions = set()
        for taxon in all_taxa:
            for country_rules in \
                    self.taxonomy_string_to_geofencing_rules[
                        taxon].values():
                for country_code, region_rules in country_rules.items():
                    all_regions.add(country_code)
                    for region_name in region_rules:
                        assert len(region_name) == 2
                        all_regions.add(country_code + ':' +
                                        region_name)
        all_regions = sorted(all_regions)

        n_allowed = 0
        df = pd.DataFrame(index=all_taxa, columns=all_regions)
        for taxon in all_taxa:
            for region in all_regions:
                tokens = region.split(':')
                state_code = tokens[1] if len(tokens) > 1 else None
                if self.species_allowed_in_country(
                        taxon, tokens[0], state=state_code):
                    df.loc[taxon, region] = 1
                    n_allowed += 1
        print('Allowed {} of {} combinations'.format(
            n_allowed, len(all_taxa) * len(all_regions)))

        for col in df.columns:
            if df[col].notna().any():
                df[col] = pd.to_numeric(df[col],
                                        errors='coerce').astype('Int64')

        if include_common_names:
            df.insert(loc=0, column='common_name', value='')
            for taxon in all_taxa:
                info = self.taxonomy_string_to_taxonomy_info.get(taxon)
                if info is not None:
                    df.loc[taxon, 'common_name'] = info['common_name']

        if csv_fn is not None:
            df.to_csv(csv_fn, index=True, header=True)
        return df

    def find_taxa_allowed_in_region(self, country, state=None):
        """
        All geofenced taxa allowed in a region, plus (implicitly) note
        that un-geofenced taxa are always allowed
        (the functional core of notebooks/wi_utils_driver.py:49-90).
        Returns the sorted list of 5-token taxonomy strings.
        """

        assert self.taxonomy_string_to_geofencing_rules is not None, \
            'Initialize geofencing prior to species lookup'
        return sorted(
            t for t in self.taxonomy_string_to_geofencing_rules
            if self.species_allowed_in_country(t, country, state=state))
