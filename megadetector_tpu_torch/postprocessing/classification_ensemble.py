"""
The port's copy of megadetector_tpu/postprocessing/
classification_ensemble.py (no device code; the port imports nothing of
the JAX package).

Classifier-output ensembling: taxonomy rollup and geofencing.

Plays the role of the SpeciesNet ensemble stage the reference invokes
(megadetector/detection/run_md_and_speciesnet.py:51-55,1067): after the
raw classifier forward, (a) geofencing zeroes out species that cannot
occur at the capture location, and (b) taxonomic rollup walks predictions
up the taxonomy until the accumulated confidence clears a threshold, so
an uncertain 'red fox vs gray fox' becomes a confident 'canidae'.

Both operate on MD results with 'classifications' arrays plus a
TaxonomyGraph (taxonomy_mapping/taxonomy_graph.py) and a geofence table
({species name: [allowed location prefixes]}).
"""

import json

from collections import defaultdict

from megadetector_tpu_torch.utils import ct_utils


class EnsembleOptions:
    """Options controlling apply_classification_ensemble()."""

    def __init__(self):
        # Roll predictions up the taxonomy until the accumulated
        # confidence at a node clears this threshold
        self.rollup_confidence_threshold = 0.65
        # Don't roll up beyond this taxonomic level (inclusive)
        self.max_rollup_level = 'class'
        # {species name: [allowed location prefixes]}; species absent
        # from the table are allowed everywhere
        self.geofence_table = None
        # Callable mapping an image dict -> location string (default:
        # the 'location' field, else the folder)
        self.location_for_image = None
        self.top_k = 3


def _default_location(im):
    if 'location' in im:
        return str(im['location'])
    import os
    return os.path.dirname(im['file'])


#%% WI / SpeciesNet taxonomy strings
#
# SpeciesNet class names are 7-part semicolon strings:
# "uuid;class;order;family;genus;species;common name"
# (reference ensemble: run_md_and_speciesnet.py:51-55). These helpers
# parse them, roll scores up taxonomic levels, and drive geofencing.

TAXONOMY_LEVELS = ('class', 'order', 'family', 'genus', 'species')


def is_taxonomy_string(name):
    return isinstance(name, str) and name.count(';') == 6


def parse_taxonomy_string(s):
    """'uuid;class;order;family;genus;species;common' -> dict."""

    parts = [p.strip() for p in str(s).split(';')]
    assert len(parts) == 7, 'Not a 7-part taxonomy string: {}'.format(s)
    out = {'uuid': parts[0], 'common_name': parts[6]}
    for level, value in zip(TAXONOMY_LEVELS, parts[1:6]):
        out[level] = value
    return out


def taxonomy_string_level(s):
    """Most specific non-empty taxonomic level of a taxonomy string
    (None for non-taxonomic entries like 'blank')."""

    parsed = parse_taxonomy_string(s)
    for level in reversed(TAXONOMY_LEVELS):
        if parsed[level]:
            return level
    return None


def truncate_taxonomy_string(s, level):
    """Taxonomy string truncated to [level] (uuid dropped, common name
    replaced by the taxon at that level)."""

    parsed = parse_taxonomy_string(s)
    values = []
    keep = True
    taxon = ''
    for lvl in TAXONOMY_LEVELS:
        if keep and parsed[lvl]:
            values.append(parsed[lvl])
            taxon = parsed[lvl]
        else:
            values.append('')
        if lvl == level:
            keep = False
    return ';'.join([''] + values + [taxon])


def rollup_taxonomy_strings(scores_by_string, threshold,
                            max_level='class'):
    """
    SpeciesNet-style rollup over 7-part taxonomy strings: accumulate
    scores at each ancestor level of the top prediction until the
    accumulated confidence clears [threshold]. Returns (label, conf)
    where label is the original string or a truncated ancestor string.
    Non-taxonomic entries (blank etc.) are returned as-is.
    """

    if not scores_by_string:
        return None
    top = max(scores_by_string, key=scores_by_string.get)
    top_score = scores_by_string[top]
    if top_score >= threshold or not is_taxonomy_string(top):
        return top, top_score

    parsed_top = parse_taxonomy_string(top)
    max_idx = TAXONOMY_LEVELS.index(max_level)
    # From most to least specific ancestor level of the top prediction
    for idx in range(len(TAXONOMY_LEVELS) - 1, max_idx - 1, -1):
        level = TAXONOMY_LEVELS[idx]
        if not parsed_top[level]:
            continue
        prefix = [parsed_top[l] for l in TAXONOMY_LEVELS[:idx + 1]]
        total = 0.0
        for name, score in scores_by_string.items():
            if not is_taxonomy_string(name):
                continue
            p = parse_taxonomy_string(name)
            if [p[l] for l in TAXONOMY_LEVELS[:idx + 1]] == prefix:
                total += score
        if total >= threshold:
            if level == taxonomy_string_level(top):
                return top, min(total, 1.0)
            return truncate_taxonomy_string(top, level), min(total, 1.0)
    return top, top_score


#%% Geofencing


def load_geofence_table(path):
    """Load a geofence table (either the simple {name: [location
    prefixes]} format or the SpeciesNet base format {species:
    {'allow'/'block': {COUNTRY: [admin1, ...]}}})."""

    with open(path) as f:
        return json.load(f)


def _parse_location(location):
    """'COUNTRY' or 'COUNTRY/ADMIN1' -> (country, admin1-or-None)."""

    if location is None:
        return None, None
    parts = str(location).split('/')
    country = parts[0].strip().upper() or None
    admin1 = parts[1].strip().upper() if len(parts) > 1 and \
        parts[1].strip() else None
    return country, admin1


def geofence_allows(entry, location):
    """
    SpeciesNet allow/block semantics for one species entry:
    {'allow': {COUNTRY: [admin1...]}, 'block': {...}}; an empty admin1
    list means the whole country. Species with no 'allow' block are
    allowed everywhere except 'block' matches.
    """

    country, admin1 = _parse_location(location)
    if country is None:
        return True

    def matches(rules):
        if rules is None:
            return False
        regions = rules.get(country)
        if regions is None:
            return False
        if not regions:
            return True
        return admin1 is not None and admin1 in [
            str(r).upper() for r in regions]

    block = entry.get('block')
    if matches(block):
        return False
    allow = entry.get('allow')
    if allow is None:
        return True
    return matches(allow)


def geofence_classifications(scores_by_name, location, geofence_table):
    """
    Zero out species not allowed at [location] and renormalize.
    [geofence_table] maps species name -> list of allowed location
    prefixes (simple format) OR -> {'allow'/'block': {...}} (SpeciesNet
    format). Returns a new {name: score}.
    """

    if not geofence_table:
        return dict(scores_by_name)

    out = {}
    any_blocked = False
    for name, score in scores_by_name.items():
        entry = geofence_table.get(name)
        if entry is not None and location is not None and score != 0.0:
            if isinstance(entry, dict):
                if not geofence_allows(entry, location):
                    score = 0.0
                    any_blocked = True
            elif not any(str(location).startswith(str(p))
                         for p in entry):
                score = 0.0
                any_blocked = True
        out[name] = score

    # Only renormalize when the geofence actually removed probability
    # mass; the stored top-k scores never sum to 1 (they're a truncation
    # of the full softmax), so unconditional renormalization would
    # inflate every confidence even when nothing was blocked.
    if any_blocked:
        total = sum(out.values())
        if total > 0:
            out = {k: v / total for k, v in out.items()}
    return out


def rollup_classifications(scores_by_name, taxonomy, threshold,
                           max_level='class'):
    """
    Walk scores up the taxonomy: if the top species is below [threshold],
    accumulate sibling scores at each ancestor until some node clears it.
    Returns (name, confidence) of the chosen prediction.
    """

    if not scores_by_name:
        return None

    top_name = max(scores_by_name, key=scores_by_name.get)
    top_score = scores_by_name[top_name]
    if top_score >= threshold or taxonomy is None:
        return top_name, top_score

    # Accumulate each prediction's score onto all of its ancestors
    node_scores = defaultdict(float)
    for name, score in scores_by_name.items():
        nodes = taxonomy.find(name)
        if not nodes:
            continue
        node = nodes[0]
        node_scores[node.name] += score
        for ancestor in taxonomy.ancestors(node):
            node_scores[ancestor.name] += score

    # Choose the most specific node clearing the threshold along the top
    # prediction's ancestor chain
    top_nodes = taxonomy.find(top_name)
    if not top_nodes:
        return top_name, top_score
    chain = [top_nodes[0]] + taxonomy.ancestors(top_nodes[0])
    for node in chain:
        score = node_scores.get(node.name, 0.0)
        if score >= threshold:
            return node.name, min(score, 1.0)
        if node.level == max_level:
            break
    return top_name, top_score


def apply_classification_ensemble(input_file, taxonomy=None,
                                  output_file=None, options=None):
    """
    Apply geofencing + rollup to every classified detection in an MD
    results file (path or dict). New category IDs are allocated for
    rolled-up taxa. Returns the (modified) dict.
    """

    if options is None:
        options = EnsembleOptions()
    location_fn = options.location_for_image or _default_location

    if isinstance(input_file, str):
        with open(input_file) as f:
            data = json.load(f)
    else:
        data = input_file

    categories = data.get('classification_categories', {})
    # When WI-style category descriptions are present (7-part taxonomy
    # strings), the ensemble operates on descriptions, not display names
    descriptions = data.get('classification_category_descriptions')
    lookup = descriptions if descriptions else categories
    name_to_id = {str(v).lower(): k for k, v in lookup.items()}

    def id_for_name(name):
        name = str(name).lower()
        if name not in name_to_id:
            new_id = str(max([int(k) for k in categories] + [-1]) + 1)
            if is_taxonomy_string(name):
                parsed = parse_taxonomy_string(name)
                categories[new_id] = parsed['common_name'] or name
            else:
                categories[new_id] = name
            if descriptions is not None:
                descriptions[new_id] = name
            name_to_id[name] = new_id
        return name_to_id[name]

    n_geofenced = 0
    n_rolled_up = 0

    for im in data['images']:
        location = location_fn(im)
        for det in im.get('detections') or []:
            classifications = det.get('classifications')
            if not classifications:
                continue
            scores = {str(lookup.get(c[0], c[0])).lower(): c[1]
                      for c in classifications}

            if options.geofence_table:
                new_scores = geofence_classifications(
                    scores, location, options.geofence_table)
                if new_scores != scores:
                    n_geofenced += 1
                scores = new_scores

            if taxonomy is None and scores and \
                    any(is_taxonomy_string(n) for n in scores):
                # WI/SpeciesNet 7-part strings are self-describing:
                # roll up within the strings themselves
                result = rollup_taxonomy_strings(
                    scores, options.rollup_confidence_threshold,
                    options.max_rollup_level)
            else:
                result = rollup_classifications(
                    scores, taxonomy,
                    options.rollup_confidence_threshold,
                    options.max_rollup_level)
            if result is None:
                det['classifications'] = []
                continue
            name, conf = result
            if name not in scores or scores.get(name, 0) != conf:
                n_rolled_up += 1

            ranked = sorted(scores.items(), key=lambda kv: -kv[1])
            out = [[id_for_name(name), round(float(conf), 4)]]
            for other_name, other_score in ranked:
                if other_name == name or other_score <= 0:
                    continue
                out.append([id_for_name(other_name),
                            round(float(other_score), 4)])
                if len(out) >= options.top_k:
                    break
            det['classifications'] = out

    data['classification_categories'] = categories
    if descriptions is not None:
        data['classification_category_descriptions'] = descriptions
    print('Ensemble: geofenced {} detections, rolled up {}'.format(
        n_geofenced, n_rolled_up))

    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data
