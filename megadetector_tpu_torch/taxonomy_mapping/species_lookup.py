"""
Species name lookup: map free-form dataset labels (common or scientific
names) to canonical taxa.

Behavioral contract follows the reference
(megadetector/taxonomy_mapping/species_lookup.py): the reference queries
downloaded GBIF/iNat taxonomy dumps; here lookups run against any local
taxonomy table loaded into a TaxonomyGraph plus a common-name synonym
map, so the pipeline works offline. Matching: exact name, synonym,
then fuzzy (token-overlap) fallback.

The port's own copy of
megadetector_tpu/taxonomy_mapping/species_lookup.py: the same public
names, signatures, defaults and output bytes.
"""

import json
import re

from megadetector_tpu_torch.taxonomy_mapping.taxonomy_graph import TaxonomyGraph


def _normalize(s):
    s = str(s).strip().lower()
    s = re.sub(r'[_\-]+', ' ', s)
    s = re.sub(r'\s+', ' ', s)
    return s


class SpeciesLookup:
    """
    Name resolver over a TaxonomyGraph + synonym table.

    Args:
        taxonomy: TaxonomyGraph, or rows for one
        synonyms: {alias: canonical name} (e.g. common -> scientific)
    """

    def __init__(self, taxonomy=None, synonyms=None):
        if taxonomy is None:
            taxonomy = TaxonomyGraph()
        elif not isinstance(taxonomy, TaxonomyGraph):
            taxonomy = TaxonomyGraph(taxonomy)
        self.taxonomy = taxonomy
        self.synonyms = {_normalize(k): _normalize(v)
                         for k, v in (synonyms or {}).items()}

    @classmethod
    def from_files(cls, taxonomy_csv=None, synonyms_json=None):
        from megadetector_tpu_torch.taxonomy_mapping.taxonomy_graph import \
            build_taxonomy_from_csv
        taxonomy = build_taxonomy_from_csv(taxonomy_csv) \
            if taxonomy_csv else None
        synonyms = None
        if synonyms_json:
            with open(synonyms_json) as f:
                synonyms = json.load(f)
        return cls(taxonomy, synonyms)

    def lookup(self, query):
        """
        Resolve [query] to a TaxonNode (or None). Tries exact match,
        synonym match, then token-overlap fuzzy match.
        """

        # Exact match first with hyphens preserved (taxonomies keep
        # them: 'black-backed jackal'), then hyphen-normalized
        raw = re.sub(r'\s+', ' ', str(query).strip().lower())
        nodes = self.taxonomy.find(raw)
        if nodes:
            return nodes[0]

        q = _normalize(query)
        nodes = self.taxonomy.find(q)
        if nodes:
            return nodes[0]

        for key in (raw, q):
            if key in self.synonyms:
                nodes = self.taxonomy.find(self.synonyms[key])
                if nodes:
                    return nodes[0]

        # Fuzzy: the query's tokens are a subset of a taxon's tokens or
        # vice versa ('white-tailed deer' ~ 'white tailed deer');
        # hyphens split for tokenization
        q_tokens = set(_normalize(query).split())
        best = None
        best_overlap = 0
        for name, nodes in self.taxonomy.name_to_nodes.items():
            n_tokens = set(_normalize(name).split())
            if not n_tokens:
                continue
            overlap = len(q_tokens & n_tokens)
            if overlap == 0:
                continue
            if q_tokens <= n_tokens or n_tokens <= q_tokens:
                if overlap > best_overlap:
                    best_overlap = overlap
                    best = nodes[0]
        return best

    def lookup_name(self, query):
        """Resolved canonical name, or None."""

        node = self.lookup(query)
        return node.name if node is not None else None

    def map_labels(self, labels):
        """{input label: canonical name or None} for a list of labels."""

        return {label: self.lookup_name(label) for label in labels}


#%% Reference-style heuristic matching
#
# The reference's get_preferred_taxonomic_match
# (taxonomy_mapping/species_lookup.py:715-800) applies camera-trap-
# specific query cleanup before/after the raw lookup; these are the
# same heuristics, running against the offline SpeciesLookup.

# Terms that datasets write space-separated but taxonomies hyphenate
HYPHENATED_TERMS = ['tailed', 'backed', 'breasted', 'crowned', 'eared',
                    'necked', 'throated', 'winged', 'footed']


class TaxonomicMatch:
    """One resolved match: the node plus its full ancestor level map
    (the reference's TaxonomicMatch, species_lookup.py:662), including
    the reference's serialized taxonomy_string
    ("[(id, level, name, (common,)), ...]", lowest taxon first) and its
    field aliases (taxonomic_level, common_name, source)."""

    def __init__(self, query, node, taxonomy, source='', match=None):
        self.query = query
        self.node = node
        self.match = match
        self.source = source
        self.scientific_name = node.name if node is not None else ''
        self.level = node.level if node is not None else ''
        self.common_name = ''
        self.taxonomy_levels = {}
        ancestry = []
        if node is not None and taxonomy is not None:
            self.taxonomy_levels[node.level] = node.name
            ancestry.append(node)
            for ancestor in taxonomy.ancestors(node):
                self.taxonomy_levels[ancestor.level] = ancestor.name
                ancestry.append(ancestor)
        self.taxonomy_string = str([
            (getattr(n, 'taxon_id', None), n.level, n.name, ())
            for n in ancestry]) if ancestry else ''

    @property
    def taxonomic_level(self):
        """Reference alias for .level."""

        return self.level

    def __repr__(self):
        return 'TaxonomicMatch({} -> {} [{}])'.format(
            self.query, self.scientific_name, self.level)


def clean_species_query(query):
    """The reference's pre-lookup normalization
    (species_lookup.py:793-800): lowercase, underscores to spaces,
    strip 'unidentified'/'unknown' and trailing ' sp'/' group'."""

    q = _normalize(query)
    q = q.replace('unidentified', '').replace('unknown', '')
    q = q.strip()
    if q.endswith(' sp'):
        q = q[:-3]
    if q.endswith(' group'):
        q = q[:-6]
    return q.strip()


def get_preferred_taxonomic_match(query, lookup, retry=True):
    """
    Resolve [query] against a SpeciesLookup with the reference's retry
    heuristics (species_lookup.py:715-760): raw lookup; then hyphenate
    compound color/body terms ('black backed jackal' ->
    'black-backed jackal'); then strip 'sp.'/'sp' suffixes; then strip
    rank words ('species', 'order', 'genus', 'family', 'subfamily').

    Returns a TaxonomicMatch (scientific_name == '' when unresolved).
    """

    q = clean_species_query(query)
    node = lookup.lookup(q)
    if node is not None or not retry:
        return TaxonomicMatch(q, node, lookup.taxonomy)

    for term in HYPHENATED_TERMS:
        q = q.replace(' ' + term, '-' + term)
    if q.endswith('.'):
        q = q[:-1].strip()
    if q.endswith(' sp'):
        q = q[:-3].strip()
    node = lookup.lookup(q)
    if node is not None:
        return TaxonomicMatch(q, node, lookup.taxonomy)

    for rank in ('species', 'order', 'genus', 'family', 'subfamily'):
        q = q.replace(rank, '').strip()
    node = lookup.lookup(q)
    return TaxonomicMatch(q, node, lookup.taxonomy)


def get_scientific_name_from_row(r):
    """
    Scientific name from a taxonomy-table row (dict or pandas Series):
    canonicalName when present and non-empty, else scientificName
    (reference: species_lookup.py:433-442).
    """

    if 'canonicalName' in r and len(r['canonicalName']) > 0:
        return r['canonicalName']
    return r['scientificName']


def taxonomy_row_to_string(r):
    """
    '<rank> <scientific name> (<vernacular>)' for a taxonomy-table row
    (reference: species_lookup.py:445-456).
    """

    common_string = ''
    if 'vernacularName' in r:
        common_string = ' (' + r['vernacularName'] + ')'
    return r['taxonRank'] + ' ' + get_scientific_name_from_row(r) + \
        common_string


def traverse_taxonomy(node, taxonomy, source, query):
    """
    Walk from [node] to the taxonomy root, producing the reference's
    match-dict shape (species_lookup.py:459-555, whose row-table
    machinery is replaced by the TaxonomyGraph walk):
    {'source', 'query', 'taxonomy': [(taxon_id, level, name,
    (common names,)), ...]} with the lowest taxon first.
    """

    chain = [node] + taxonomy.ancestors(node)
    return {
        'source': source,
        'query': query,
        'taxonomy': [(getattr(n, 'taxon_id', None), n.level, n.name,
                      ()) for n in chain],
    }


def get_taxonomic_info(query, lookups=None):
    """
    Taxonomic matches for [query] (scientific or common name) from
    every loaded taxonomy; returns a list of match dicts (see
    traverse_taxonomy), GBIF matches first (reference:
    species_lookup.py:558-599). [lookups] is the
    {'gbif': SpeciesLookup, 'inat': SpeciesLookup} dict from
    initialize_taxonomy_lookup (the reference keeps these as module
    globals; here they're explicit).
    """

    assert lookups is not None, \
        'Pass the lookups dict from initialize_taxonomy_lookup()'
    query = query.strip().lower()

    matches = []
    for source in sorted(lookups):  # 'gbif' before 'inat'
        lookup = lookups[source]
        node = lookup.lookup(query)
        if node is not None:
            matches.append(traverse_taxonomy(node, lookup.taxonomy,
                                             source, query))
    return matches


def print_taxonomy_matches(matches, verbose=False):
    """
    Console-friendly printing of get_taxonomic_info matches as
    indented trees (reference: species_lookup.py:602-636); only the
    lowest level prints unless [verbose].
    """

    for m in matches:
        source = m['source']
        for i_level, level_info in enumerate(m['taxonomy']):
            taxonomy_level = level_info[1]
            name = level_info[2]
            common = level_info[3]
            if i_level > 0:
                print('\t', end='')
            print('{} {} ({})'.format(taxonomy_level, name, common),
                  end='')
            print(' ({})'.format(source) if i_level == 0 else '')
            if not verbose:
                break


def slugify(value, allow_unicode=False):
    """
    Django-style slugify: normalize unicode, lowercase, collapse
    non-alphanumerics to single hyphens (reference:
    species_lookup.py:644-683).
    """

    import unicodedata

    value = str(value)
    if allow_unicode:
        value = unicodedata.normalize('NFKC', value)
    else:
        value = unicodedata.normalize('NFKD', value).encode(
            'ascii', 'ignore').decode('ascii')
    value = re.sub(r'[^\w\s-]', '', value.lower())
    return re.sub(r'[-\s]+', '-', value).strip('-_')


def pop_levels(m, n_levels=1):
    """
    Remove [n_levels] levels from the bottom of a TaxonomicMatch,
    typically to drop silly subgenera; returns a new TaxonomicMatch
    whose name/level/taxonomy_string reflect the popped ancestry
    (reference: species_lookup.py:686-712).
    """

    import ast

    v = ast.literal_eval(m.taxonomy_string)
    assert v[0][1] == m.taxonomic_level
    assert v[0][2] == m.scientific_name
    popped_v = v[n_levels:]
    assert popped_v, 'Cannot pop every level from a match'

    popped = TaxonomicMatch(m.query, None, None, source=m.source)
    popped.level = popped_v[0][1]
    popped.scientific_name = popped_v[0][2]
    common_name = popped_v[0][3]
    popped.common_name = common_name[0] if common_name else ''
    popped.taxonomy_string = str(popped_v)
    popped.taxonomy_levels = {t[1]: t[2] for t in popped_v}
    return popped


def validate_and_convert(data):
    """
    Recursively validate that [data] contains only tuples/lists/ints/
    strings/np.int64, converting np.int64 to int (reference:
    species_lookup.py:762-789). Raises TypeError otherwise.
    """

    import numpy as np

    if isinstance(data, np.int64):
        return int(data)
    elif isinstance(data, (int, str)):
        return data
    elif isinstance(data, (list, tuple)):
        container_type = type(data)
        return container_type(validate_and_convert(item)
                              for item in data)
    else:
        raise TypeError(
            'Invalid type encountered: {}. Only int, np.int64, str, '
            'list, and tuple are allowed.'.format(type(data).__name__))


def load_gbif_backbone(taxon_tsv, max_rows=None,
                       kingdoms=('animalia',)):
    """
    Build a SpeciesLookup from a local GBIF backbone Taxon.tsv dump
    (the file the reference's initialize_taxonomy_lookup downloads,
    species_lookup.py:77; this loader works on any local copy — this
    framework never assumes egress). Columns used: taxonID,
    parentNameUsageID, canonicalName, taxonRank, kingdom,
    vernacularName (when present).

    Returns a SpeciesLookup whose taxonomy carries the parent chains.
    """

    import csv

    rows = []
    synonyms = {}
    wanted_kingdoms = {k.lower() for k in kingdoms} if kingdoms else None
    with open(taxon_tsv, newline='', encoding='utf-8',
              errors='replace') as f:
        reader = csv.DictReader(f, delimiter='\t')
        for i, rec in enumerate(reader):
            if max_rows is not None and i >= max_rows:
                break
            kingdom = (rec.get('kingdom') or '').lower()
            if wanted_kingdoms and kingdom and \
                    kingdom not in wanted_kingdoms:
                continue
            name = rec.get('canonicalName') or \
                rec.get('scientificName') or ''
            if not name:
                continue
            rows.append((rec['taxonID'],
                         (rec.get('taxonRank') or 'unknown').lower(),
                         name,
                         rec.get('parentNameUsageID') or None))
            vern = rec.get('vernacularName')
            if vern:
                synonyms[vern] = name
    return SpeciesLookup(TaxonomyGraph(rows), synonyms)


def load_gbif_vernacular(vernacular_tsv, max_rows=None,
                         languages=('en',)):
    """
    {vernacular_name: taxonID} from a GBIF VernacularName.tsv dump
    (columns: taxonID, vernacularName, language).
    """

    import csv

    out = {}
    langs = {lang.lower() for lang in languages} if languages else None
    with open(vernacular_tsv, newline='', encoding='utf-8',
              errors='replace') as f:
        reader = csv.DictReader(f, delimiter='\t')
        for i, rec in enumerate(reader):
            if max_rows is not None and i >= max_rows:
                break
            lang = (rec.get('language') or '').lower()
            if langs and lang and lang not in langs:
                continue
            name = rec.get('vernacularName')
            if name:
                out.setdefault(_normalize(name), rec.get('taxonID'))
    return out


def load_inat_taxonomy(taxa_csv, vernacular_csv=None, max_rows=None,
                       kingdoms=('animalia',)):
    """
    Build a SpeciesLookup from an iNaturalist DwC-A dump's taxa.csv
    (columns: id, parentNameUsageID, kingdom, scientificName,
    taxonRank) plus the optional VernacularNames-english.csv
    (id, vernacularName). Reference source files:
    species_lookup.py files_to_unzip['iNaturalist'].
    """

    import csv

    rows = []
    id_to_name = {}
    wanted_kingdoms = {k.lower() for k in kingdoms} if kingdoms else None
    with open(taxa_csv, newline='', encoding='utf-8',
              errors='replace') as f:
        reader = csv.DictReader(f)
        for i, rec in enumerate(reader):
            if max_rows is not None and i >= max_rows:
                break
            kingdom = (rec.get('kingdom') or '').lower()
            if wanted_kingdoms and kingdom and \
                    kingdom not in wanted_kingdoms:
                continue
            name = rec.get('scientificName') or ''
            if not name:
                continue
            taxon_id = rec.get('id') or rec.get('taxonID')
            # iNat parent references arrive as URLs or bare ids;
            # normalize to the trailing id token
            parent = rec.get('parentNameUsageID') or None
            if parent and '/' in parent:
                parent = parent.rstrip('/').split('/')[-1]
            rows.append((taxon_id,
                         (rec.get('taxonRank') or 'unknown').lower(),
                         name, parent))
            id_to_name[str(taxon_id)] = name

    synonyms = {}
    if vernacular_csv:
        with open(vernacular_csv, newline='', encoding='utf-8',
                  errors='replace') as f:
            for rec in csv.DictReader(f):
                taxon_id = str(rec.get('id') or '')
                vern = rec.get('vernacularName')
                if vern and taxon_id in id_to_name:
                    synonyms.setdefault(vern, id_to_name[taxon_id])
    return SpeciesLookup(TaxonomyGraph(rows), synonyms)


# Current dump locations (reference: species_lookup.py:33-35). Downloads
# happen only when initialize_taxonomy_lookup runs on a host with egress.
TAXONOMY_URLS = {
    'GBIF': 'https://hosted-datasets.gbif.org/datasets/backbone/current/'
            'backbone.zip',
    'iNaturalist': 'https://www.inaturalist.org/taxa/'
                   'inaturalist-taxonomy.dwca.zip',
}

FILES_TO_UNZIP = {
    'GBIF': ['Taxon.tsv', 'VernacularName.tsv'],
    'iNaturalist': ['taxa.csv', 'VernacularNames-english.csv'],
}


def initialize_taxonomy_lookup(taxonomy_dir, force_init=False,
                               download_fn=None, unzip_fn=None,
                               max_rows=None, verbose=True):
    """
    Download (when needed), unzip, and load the GBIF + iNat taxonomies
    (the reference's module-initialization flow,
    species_lookup.py:76-180, as a function with injectable transport
    so it tests offline and degrades cleanly on zero-egress hosts).

    Args:
        taxonomy_dir: working directory for zips/extracted files
        force_init: re-download and re-parse even if files exist
        download_fn: (url, dest_path) -> None; defaults to
            utils.url_utils.download_url. On hosts without egress, pass
            pre-staged files and no download occurs.
        unzip_fn: (zip_path, out_dir) -> None; defaults to
            utils.path_utils.unzip_file
        max_rows: row cap per source (tests / smoke)

    Returns:
        {'gbif': SpeciesLookup, 'inat': SpeciesLookup}
    """

    import os

    from megadetector_tpu_torch.utils import path_utils, url_utils

    download_fn = download_fn or (
        lambda url, dest: url_utils.download_url(
            url, dest, verbose=verbose))
    unzip_fn = unzip_fn or path_utils.unzip_file

    os.makedirs(taxonomy_dir, exist_ok=True)
    for name, url in TAXONOMY_URLS.items():
        out_dir = os.path.join(taxonomy_dir, name)
        needed = [os.path.join(out_dir, fn)
                  for fn in FILES_TO_UNZIP[name]]
        if not force_init and all(os.path.isfile(p) for p in needed):
            if verbose:
                print('Bypassing download of {}: files available'.format(
                    name))
            continue
        zip_path = os.path.join(taxonomy_dir, url.split('/')[-1])
        if force_init or not os.path.isfile(zip_path):
            download_fn(url, zip_path)
        os.makedirs(out_dir, exist_ok=True)
        unzip_fn(zip_path, out_dir)
        missing = [p for p in needed if not os.path.isfile(p)]
        assert not missing, \
            'Archive for {} did not contain {}'.format(name, missing)

    gbif_dir = os.path.join(taxonomy_dir, 'GBIF')
    inat_dir = os.path.join(taxonomy_dir, 'iNaturalist')
    gbif = load_gbif_backbone(os.path.join(gbif_dir, 'Taxon.tsv'),
                              max_rows=max_rows)
    gbif.synonyms.update({
        _normalize(k): _normalize(v) for k, v in _gbif_vernacular_names(
            os.path.join(gbif_dir, 'VernacularName.tsv'), gbif,
            max_rows=max_rows).items()})
    inat = load_inat_taxonomy(
        os.path.join(inat_dir, 'taxa.csv'),
        os.path.join(inat_dir, 'VernacularNames-english.csv'),
        max_rows=max_rows)
    return {'gbif': gbif, 'inat': inat}


def _gbif_vernacular_names(vernacular_tsv, gbif_lookup, max_rows=None):
    """{vernacular: scientific} resolved through the backbone's ids."""

    id_to_name = {str(taxon_id): node.name for taxon_id, node in
                  gbif_lookup.taxonomy.id_to_node.items()}
    name_to_id = load_gbif_vernacular(vernacular_tsv, max_rows=max_rows)
    return {vern: id_to_name[str(taxon_id)]
            for vern, taxon_id in name_to_id.items()
            if str(taxon_id) in id_to_name}


def main():
    """CLI: resolve species names against a local taxonomy (reference
    species_lookup.py's interactive lookup as a batch tool)."""

    import argparse
    import sys

    parser = argparse.ArgumentParser(
        description='Look up species names in a local taxonomy')
    parser.add_argument('queries', nargs='+',
                        help='common or scientific names')
    parser.add_argument('--taxonomy_csv', default=None,
                        help='taxonomy table (taxon_id/level/name/'
                             'parent_id CSV)')
    parser.add_argument('--gbif_taxon_tsv', default=None,
                        help='GBIF backbone Taxon.tsv dump')
    parser.add_argument('--synonyms_json', default=None)
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()

    if args.gbif_taxon_tsv:
        lookup = load_gbif_backbone(args.gbif_taxon_tsv)
    else:
        lookup = SpeciesLookup.from_files(args.taxonomy_csv,
                                          args.synonyms_json)

    n_missing = 0
    for query in args.queries:
        node = lookup.lookup(query)
        if node is None:
            print('{}: NO MATCH'.format(query))
            n_missing += 1
        else:
            print('{}: {} ({})'.format(query, node.name, node.level))
    sys.exit(1 if n_missing else 0)


if __name__ == '__main__':
    main()
