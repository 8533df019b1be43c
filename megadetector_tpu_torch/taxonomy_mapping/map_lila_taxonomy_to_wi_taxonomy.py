"""
Map LILA taxonomy rows to the Wildlife Insights (SpeciesNet) taxonomy.

The reference runs this as a manually-driven notebook
(megadetector/taxonomy_mapping/map_lila_taxonomy_to_wi_taxonomy.py:1-30):
look each LILA category's scientific name up in the WI taxonomy, walk UP
the LILA ancestry when WI has no entry at that level (e.g. tribes, which
SpeciesNet doesn't use), consult a manually-curated supplementary CSV for
the stragglers, and emit lila_wi_mapping_table.csv.

Here the whole pipeline is a deterministic function over three inputs
(LILA mapping CSV, WI taxonomy release, supplementary CSV), so it runs
offline and under test; rows it cannot map are labeled 'unmapped' for
manual follow-up rather than interactive fixing.

The port's own copy of
megadetector_tpu/taxonomy_mapping/map_lila_taxonomy_to_wi_taxonomy.py:
the same public names, signatures, defaults and output bytes.
"""

import ast
import csv
import sys

from megadetector_tpu_torch.utils.wi_taxonomy_utils import (
    TaxonomyHandler,
    taxonomy_level_to_string,
)


def build_wi_name_index(handler):
    """
    {taxon_name: prediction_string} for the LOWEST populated level of
    every WI prediction string — unlike TaxonomyHandler's latin index,
    this also covers class/order/family-level entries.
    """

    index = {}
    for s in handler.prediction_strings:
        tokens = s.split(';')
        # tokens: uuid;class;order;family;genus;species;common
        genus, species = tokens[4].strip(), tokens[5].strip()
        if genus and species:
            name = '{} {}'.format(genus, species)
        else:
            name = next((tokens[i].strip() for i in (4, 3, 2, 1)
                         if tokens[i].strip()), '')
        if name:
            index.setdefault(name, s)
    return index


def load_supplementary_mapping(path_or_rows):
    """{lila_name_lower: wi_name_lower} from the curated CSV
    (columns: lila_name, wi_name)."""

    if isinstance(path_or_rows, dict):
        return {k.lower(): v.lower() for k, v in path_or_rows.items()}
    out = {}
    with open(path_or_rows, newline='') as f:
        for row in csv.DictReader(f):
            out[row['lila_name'].strip().lower()] = \
                row['wi_name'].strip().lower()
    return out


def map_name_to_wi(name, ancestry, wi_index, handler,
                   supplementary=None):
    """
    Map one LILA taxon to a WI prediction string.

    Args:
        name: LILA scientific name (may be None/'' for non-taxonomic
            categories like 'empty')
        ancestry: LILA taxonomy_string entries [(id, level, name,
            common), ...] lowest level first (may be None)
        wi_index: from build_wi_name_index
        handler: TaxonomyHandler (for common-name fallback)
        supplementary: {lila_name: wi_name} manual overrides

    Returns:
        (prediction_string or None, how) where how is 'exact',
        'ancestor:<level>', 'supplementary', 'common_name', or
        'unmapped'.
    """

    supplementary = supplementary or {}

    def resolve(n):
        n = str(n).strip().lower()
        if not n:
            return None
        if n in supplementary:
            target = supplementary[n]
            return wi_index.get(target) or handler.string_for_name(target)
        return None

    if name:
        key = str(name).strip().lower()
        override = resolve(key)
        if override is not None:
            return override, 'supplementary'
        if key in wi_index:
            return wi_index[key], 'exact'
        s = handler.string_for_name(key)
        if s is not None:
            return s, 'common_name'

    for entry in (ancestry or [])[1:]:
        level, taxon_name = entry[1], str(entry[2]).strip().lower()
        override = resolve(taxon_name)
        if override is not None:
            return override, 'supplementary'
        if taxon_name in wi_index:
            return wi_index[taxon_name], 'ancestor:{}'.format(level)

    return None, 'unmapped'


def map_lila_taxonomy_to_wi(lila_csv, wi_taxonomy_source,
                            supplementary_mapping=None,
                            output_file=None, verbose=False):
    """
    Produce the LILA -> WI mapping table.

    Args:
        lila_csv: the LILA taxonomy mapping CSV (dataset_name, query,
            scientific_name, taxonomy_string columns)
        wi_taxonomy_source: WI taxonomy release (path or list of
            prediction strings)
        supplementary_mapping: curated CSV path or {lila: wi} dict
        output_file: optional CSV to write

    Returns:
        list of row dicts: dataset_name, query, scientific_name,
        wi_prediction_string, mapping_method.
    """

    handler = TaxonomyHandler(wi_taxonomy_source)
    wi_index = build_wi_name_index(handler)
    supplementary = load_supplementary_mapping(supplementary_mapping) \
        if supplementary_mapping is not None else {}

    out_rows = []
    with open(lila_csv, newline='') as f:
        for row in csv.DictReader(f):
            raw = row.get('taxonomy_string') or ''
            try:
                ancestry = ast.literal_eval(raw) if raw else None
            except (ValueError, SyntaxError):
                ancestry = None
            s, how = map_name_to_wi(
                row.get('scientific_name'), ancestry, wi_index, handler,
                supplementary)
            if verbose and s is None:
                print('unmapped: {}:{} ({})'.format(
                    row.get('dataset_name'), row.get('query'),
                    row.get('scientific_name')))
            out_rows.append({
                'dataset_name': row.get('dataset_name', ''),
                'query': row.get('query', ''),
                'scientific_name': row.get('scientific_name', ''),
                'wi_prediction_string': s or '',
                'mapping_method': how,
            })

    if output_file is not None:
        with open(output_file, 'w', newline='') as f:
            writer = csv.DictWriter(f, fieldnames=list(out_rows[0]))
            writer.writeheader()
            writer.writerows(out_rows)
    return out_rows


def main():
    import argparse
    parser = argparse.ArgumentParser(
        description='Map the LILA taxonomy to the WI taxonomy')
    parser.add_argument('lila_taxonomy_csv')
    parser.add_argument('wi_taxonomy_file')
    parser.add_argument('output_file')
    parser.add_argument('--supplementary_mapping_file', default=None)
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()
    rows = map_lila_taxonomy_to_wi(
        args.lila_taxonomy_csv, args.wi_taxonomy_file,
        supplementary_mapping=args.supplementary_mapping_file,
        output_file=args.output_file, verbose=True)
    unmapped = sum(1 for r in rows if r['mapping_method'] == 'unmapped')
    print('Mapped {} rows ({} unmapped) -> {}'.format(
        len(rows), unmapped, args.output_file))


# taxonomy_level_to_string is re-exported for mapping-table consumers
__all__ = ['map_lila_taxonomy_to_wi', 'map_name_to_wi',
           'build_wi_name_index', 'load_supplementary_mapping',
           'taxonomy_level_to_string']


if __name__ == '__main__':
    main()
