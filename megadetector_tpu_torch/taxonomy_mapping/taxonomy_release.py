"""
LILA taxonomy preview, consistency checking, and release preparation.

Covers the reference's three cell-style taxonomy-maintenance scripts as
proper functions:

- preview_lila_taxonomy.py (575 LoC): taxonomy-string helpers, internal
  consistency checks (scientific name / level vs the taxonomy string),
  null-mapping and missing-common-name listings, cross-dataset
  inconsistency detection, and an HTML preview of every mapping. (The
  reference also downloads sample LILA images per query; that needs
  egress and is represented by the image-URL columns in the preview.)
- map_new_lila_datasets.py (216 LoC): build the intermediate mapping
  CSV for a new dataset's category list via species_lookup.
- prepare_lila_taxonomy_release.py (163 LoC): drop mappings unused by
  any dataset's category list, expand each taxonomy string into
  per-level columns, drop the private 'source' column, write the
  release CSV.

The taxonomy mapping CSV columns follow the reference:
dataset_name, query, taxonomy_level, scientific_name, common_name,
taxonomy_string, source. A taxonomy string is the repr of a list of
(taxon_id, level, scientific_name, [common names]) tuples, most
specific first (parsed here with ast.literal_eval, never eval).

The port's own copy of
megadetector_tpu/taxonomy_mapping/taxonomy_release.py: the same public
names, signatures, defaults and output bytes.
"""

import argparse
import ast
import csv
import json
import os
import sys

# Taxonomic levels exported to release files, broad -> narrow
# (reference prepare_lila_taxonomy_release.py:78-97)
RELEASE_LEVELS = [
    'kingdom', 'phylum', 'subphylum', 'superclass', 'class', 'subclass',
    'infraclass', 'superorder', 'order', 'suborder', 'infraorder',
    'superfamily', 'family', 'subfamily', 'tribe', 'genus', 'subgenus',
    'species', 'subspecies', 'variety',
]

# Levels that appear in source taxonomies but are excluded from
# releases (reference :99-104)
EXCLUDED_LEVELS = ['stateofmatter', 'zoosection', 'parvorder',
                   'complex', 'epifamily']


#%% Taxonomy-string helpers (reference preview_lila_taxonomy.py:28-55)


def parse_taxonomy_string(taxonomy_string):
    """Parse a taxonomy string into its list of (id, level, name,
    [common names]) tuples; [] for empty/NaN-ish input."""

    if not isinstance(taxonomy_string, str) or \
            len(taxonomy_string.strip()) == 0:
        return []
    parsed = ast.literal_eval(taxonomy_string)
    if isinstance(parsed, tuple) and len(parsed) == 4 and \
            not isinstance(parsed[0], tuple):
        parsed = [parsed]
    return list(parsed)


def taxonomy_string_to_scientific(taxonomy_string):
    """The most specific match's scientific name ('' when empty)."""

    parsed = parse_taxonomy_string(taxonomy_string)
    return parsed[0][2] if parsed else ''


def taxonomy_string_to_level(taxonomy_string):
    parsed = parse_taxonomy_string(taxonomy_string)
    return parsed[0][1] if parsed else ''


def taxonomy_string_to_common_name(taxonomy_string):
    parsed = parse_taxonomy_string(taxonomy_string)
    if not parsed or not parsed[0][3]:
        return ''
    names = parsed[0][3]
    return names[0] if isinstance(names, (list, tuple)) else str(names)


#%% Mapping-file IO


def read_taxonomy_csv(csv_path):
    """Read a taxonomy mapping CSV into a list of row dicts."""

    with open(csv_path, newline='') as f:
        return list(csv.DictReader(f))


def write_taxonomy_csv(rows, csv_path, fieldnames=None):
    if fieldnames is None:
        fieldnames = list(rows[0].keys())
    with open(csv_path, 'w', newline='') as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        writer.writeheader()
        for r in rows:
            writer.writerow(r)


#%% Consistency checks (reference preview_lila_taxonomy.py:66-250)


def check_taxonomy_consistency(rows, lookup=None):
    """
    Validate a taxonomy mapping: per-row internal consistency
    (scientific_name and taxonomy_level must match the taxonomy
    string), plus — when a SpeciesLookup is provided — staleness
    against the current taxonomy. Returns a dict of issue lists.
    """

    issues = {
        'scientific_name_mismatches': [],
        'level_mismatches': [],
        'null_mappings': [],
        'missing_common_names': [],
        'stale_mappings': [],
        'cross_dataset_inconsistencies': [],
    }

    query_to_mappings = {}

    for row in rows:
        key = '{}:{}'.format(row.get('dataset_name', ''),
                             row.get('query', ''))
        ts = row.get('taxonomy_string', '')
        sn = row.get('scientific_name', '')

        if not isinstance(ts, str) or len(ts.strip()) == 0:
            issues['null_mappings'].append(key)
            continue

        if sn != taxonomy_string_to_scientific(ts):
            issues['scientific_name_mismatches'].append(
                '{}: {} vs {}'.format(
                    key, sn, taxonomy_string_to_scientific(ts)))
        level = row.get('taxonomy_level', '')
        if level and level != taxonomy_string_to_level(ts):
            issues['level_mismatches'].append(
                '{}: {} vs {}'.format(
                    key, level, taxonomy_string_to_level(ts)))
        if not row.get('common_name'):
            issues['missing_common_names'].append(key)

        query_to_mappings.setdefault(row.get('query', ''), set()).add(sn)

        if lookup is not None and sn:
            from megadetector_tpu_torch.taxonomy_mapping.species_lookup import \
                get_preferred_taxonomic_match
            m = get_preferred_taxonomic_match(sn, lookup)
            if m.scientific_name and m.scientific_name != sn:
                issues['stale_mappings'].append(
                    '{}: {} -> {}'.format(key, sn, m.scientific_name))

    # The same query string mapping to different taxa across datasets
    # is suspicious (reference :152-250); datasets can legitimately
    # differ, so this is a review list, not an error
    for query, names in query_to_mappings.items():
        names = {n for n in names if n}
        if len(names) > 1:
            issues['cross_dataset_inconsistencies'].append(
                '{}: {}'.format(query, sorted(names)))

    return issues


#%% Preview (reference preview_lila_taxonomy.py:252-575)


def preview_lila_taxonomy(taxonomy_csv, output_dir, lookup=None):
    """
    Write an HTML preview of the taxonomy mapping — one row per
    mapping with dataset, query, resolved scientific/common name,
    level, and the full taxonomy chain — plus an issues section from
    check_taxonomy_consistency. Returns the index path.
    """

    rows = read_taxonomy_csv(taxonomy_csv)
    issues = check_taxonomy_consistency(rows, lookup=lookup)
    os.makedirs(output_dir, exist_ok=True)
    index_path = os.path.join(output_dir, 'taxonomy_preview.html')

    with open(index_path, 'w') as f:
        f.write('<html><head><meta charset="utf-8"/></head><body>\n')
        f.write('<h1>LILA taxonomy mapping preview</h1>\n')
        f.write('<p>{} mappings</p>\n'.format(len(rows)))

        f.write('<h2>Issues</h2>\n')
        for name, items in issues.items():
            f.write('<h3>{} ({})</h3>\n<ul>\n'.format(
                name.replace('_', ' '), len(items)))
            for item in items[:200]:
                f.write('<li>{}</li>\n'.format(item))
            f.write('</ul>\n')

        f.write('<h2>Mappings</h2>\n')
        f.write('<table border=1 cellpadding=3 '
                'style="border-collapse:collapse">\n')
        f.write('<tr><th>dataset</th><th>query</th><th>level</th>'
                '<th>scientific</th><th>common</th>'
                '<th>taxonomy chain</th></tr>\n')
        for row in rows:
            chain = ' &gt; '.join(
                '{} ({})'.format(t[2], t[1])
                for t in reversed(
                    parse_taxonomy_string(
                        row.get('taxonomy_string', ''))))
            f.write('<tr><td>{}</td><td>{}</td><td>{}</td><td>{}</td>'
                    '<td>{}</td><td>{}</td></tr>\n'.format(
                        row.get('dataset_name', ''),
                        row.get('query', ''),
                        row.get('taxonomy_level', ''),
                        row.get('scientific_name', ''),
                        row.get('common_name', ''), chain))
        f.write('</table>\n</body></html>\n')

    print('Wrote taxonomy preview to {}'.format(index_path))
    return index_path


#%% New-dataset mapping (reference map_new_lila_datasets.py:1-216)


def map_new_dataset(dataset_name, category_names, lookup,
                    output_csv=None):
    """
    Build the intermediate mapping rows for a new dataset's category
    list by resolving each category against the taxonomy. Unresolvable
    categories produce empty-mapping rows for manual review. Returns
    the rows; appends/writes [output_csv] when given.
    """

    from megadetector_tpu_torch.taxonomy_mapping.species_lookup import \
        get_preferred_taxonomic_match

    rows = []
    for name in category_names:
        query = name.lower().strip()
        m = get_preferred_taxonomic_match(query, lookup)
        if m.node is not None:
            chain = []
            node = m.node
            chain.append((0, node.level, node.name, []))
            for ancestor in lookup.taxonomy.ancestors(node):
                chain.append((0, ancestor.level, ancestor.name, []))
            ts = repr(chain)
            rows.append({
                'dataset_name': dataset_name,
                'query': query,
                'taxonomy_level': m.level,
                'scientific_name': m.scientific_name,
                'common_name': '',
                'taxonomy_string': ts,
                'source': 'lookup',
            })
        else:
            rows.append({
                'dataset_name': dataset_name,
                'query': query,
                'taxonomy_level': '',
                'scientific_name': '',
                'common_name': '',
                'taxonomy_string': '',
                'source': 'unmapped',
            })

    if output_csv is not None:
        exists = os.path.isfile(output_csv)
        with open(output_csv, 'a', newline='') as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            if not exists:
                writer.writeheader()
            for r in rows:
                writer.writerow(r)
    return rows


#%% Release preparation (reference prepare_lila_taxonomy_release.py)


def prepare_taxonomy_release(taxonomy_csv, release_csv,
                             dataset_to_categories_json=None,
                             overwrite=False):
    """
    Produce the public release CSV: drop mappings no dataset uses
    (when a dataset->categories JSON is given), expand each taxonomy
    string into one column per RELEASE_LEVEL, drop the private
    'source' column. Returns the written rows.
    """

    if os.path.isfile(release_csv) and not overwrite:
        raise ValueError(
            'File {} exists; delete it before proceeding'.format(
                release_csv))

    rows = read_taxonomy_csv(taxonomy_csv)

    if dataset_to_categories_json is not None:
        with open(dataset_to_categories_json) as f:
            ds_to_cats = json.load(f)
        used = set()
        for ds_name, categories in ds_to_cats.items():
            for cat in categories:
                name = cat['name'].lower() if isinstance(cat, dict) \
                    else str(cat).lower()
                used.add('{}:{}'.format(ds_name, name))
        kept = []
        for row in rows:
            key = '{}:{}'.format(row.get('dataset_name', ''),
                                 row.get('query', ''))
            if key in used:
                kept.append(row)
            else:
                print('Dropping unused mapping {}'.format(key))
        print('Dropping {} of {} mappings'.format(
            len(rows) - len(kept), len(rows)))
        rows = kept

    out_rows = []
    for row in rows:
        out = {k: v for k, v in row.items() if k != 'source'}
        for level in RELEASE_LEVELS:
            out[level] = ''
        for t in parse_taxonomy_string(row.get('taxonomy_string', '')):
            level = t[1]
            if level in RELEASE_LEVELS:
                out[level] = t[2]
            elif level not in EXCLUDED_LEVELS and isinstance(level, str):
                print('Warning: unrecognized level {}'.format(level))
        out_rows.append(out)

    fieldnames = [k for k in rows[0].keys() if k != 'source'] + \
        RELEASE_LEVELS if rows else RELEASE_LEVELS
    write_taxonomy_csv(out_rows, release_csv, fieldnames=fieldnames)
    print('Wrote release taxonomy ({} rows) to {}'.format(
        len(out_rows), release_csv))
    return out_rows


def main():
    parser = argparse.ArgumentParser(
        description='Taxonomy mapping preview / release preparation')
    sub = parser.add_subparsers(dest='command', required=True)

    p = sub.add_parser('preview')
    p.add_argument('taxonomy_csv')
    p.add_argument('output_dir')

    p = sub.add_parser('release')
    p.add_argument('taxonomy_csv')
    p.add_argument('release_csv')
    p.add_argument('--dataset_to_categories', default=None)
    p.add_argument('--overwrite', action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    if args.command == 'preview':
        preview_lila_taxonomy(args.taxonomy_csv, args.output_dir)
    else:
        prepare_taxonomy_release(
            args.taxonomy_csv, args.release_csv,
            dataset_to_categories_json=args.dataset_to_categories,
            overwrite=args.overwrite)


if __name__ == '__main__':
    main()
