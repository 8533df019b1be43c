"""
Consistency checks for a LILA-style taxonomy mapping CSV.

Row schema (reference: megadetector/taxonomy_mapping/taxonomy_csv_checker.py:
1-15): dataset_name, query, taxonomy_level, scientific_name,
taxonomy_string — where taxonomy_string is a Python-literal list of
(taxon_id, level, scientific_name, common_names) tuples ordered from the
mapped taxon UP to the root.

Checks per row:
  1. the 'taxonomy_level' column equals the level of the FIRST entry of
     taxonomy_string (the lowest-level taxon);
  2. the 'scientific_name' column equals that entry's name.

Graph checks across rows: nodes keyed by (level, name) with child->parent
edges from adjacent taxonomy_string entries must form a DAG, and any node
with two parents where neither parent is an ancestor of the other is
reported as ambiguous.

The port's own copy of
megadetector_tpu/taxonomy_mapping/taxonomy_csv_checker.py: the same
public names, signatures, defaults and output bytes.
"""

import ast
import csv
import sys


def _parse_taxonomy_string(value):
    if value is None or value == '' or value == 'nan':
        return None
    return ast.literal_eval(value)


def check_taxonomy_csv(csv_path, verbose=True):
    """
    Run all checks on [csv_path].

    Returns a dict with 'n_rows', 'taxon_level_errors',
    'scientific_name_errors', 'ambiguous_parent_nodes' (list of
    (level, name)), and 'cycle' (bool).
    """

    def log(msg):
        if verbose:
            print(msg)

    n_rows = 0
    level_errors = []
    name_errors = []
    parents = {}   # (level, name) -> set of (level, name)

    with open(csv_path, newline='') as f:
        reader = csv.DictReader(f)
        for i_row, row in enumerate(reader):
            n_rows += 1
            try:
                ancestry = _parse_taxonomy_string(
                    row.get('taxonomy_string'))
            except (ValueError, SyntaxError) as e:
                level_errors.append((i_row, 'unparseable: {}'.format(e)))
                continue
            if ancestry is None:
                # Unmapped rows are legal (dataset_labels-only entries)
                continue

            first_id, first_level, first_name = ancestry[0][:3]
            if row.get('taxonomy_level') != first_level:
                level_errors.append((i_row, row.get('dataset_name'),
                                     row.get('query'),
                                     row.get('taxonomy_level'),
                                     first_level))
                log('row {} ({}:{}): taxonomy_level column {} != '
                    'taxonomy_string level {}'.format(
                        i_row, row.get('dataset_name'), row.get('query'),
                        row.get('taxonomy_level'), first_level))
            if row.get('scientific_name') != first_name:
                name_errors.append((i_row, row.get('dataset_name'),
                                    row.get('query'),
                                    row.get('scientific_name'),
                                    first_name))
                log('row {} ({}:{}): scientific_name column {} != '
                    'taxonomy_string name {}'.format(
                        i_row, row.get('dataset_name'), row.get('query'),
                        row.get('scientific_name'), first_name))

            for child, parent in zip(ancestry[:-1], ancestry[1:]):
                child_key = (child[1], child[2])
                parent_key = (parent[1], parent[2])
                parents.setdefault(child_key, set()).add(parent_key)
                parents.setdefault(parent_key, set())

    # Ancestor closure (iterative; the taxonomy is shallow)
    def ancestors(key, seen=None):
        seen = seen if seen is not None else set()
        for p in parents.get(key, ()):
            if p not in seen:
                seen.add(p)
                ancestors(p, seen)
        return seen

    # Cycle check: a node that is its own ancestor
    cycle = any(key in ancestors(key) for key in parents)
    if cycle:
        log('ERROR: taxonomy graph contains a cycle')

    ambiguous = []
    for key, ps in parents.items():
        if len(ps) < 2:
            continue
        ps = list(ps)
        resolved = any(
            a in ancestors(b) for a in ps for b in ps if a != b)
        if not resolved:
            ambiguous.append(key)
            log('Node with ambiguous parents: {} <- {}'.format(key, ps))

    log('Processed {} rows from {}'.format(n_rows, csv_path))
    log('taxon level errors: {}'.format(len(level_errors)))
    log('scientific name errors: {}'.format(len(name_errors)))

    return {
        'n_rows': n_rows,
        'taxon_level_errors': level_errors,
        'scientific_name_errors': name_errors,
        'ambiguous_parent_nodes': ambiguous,
        'cycle': cycle,
    }


def main():
    import argparse
    parser = argparse.ArgumentParser(
        description='Check a taxonomy mapping CSV for consistency')
    parser.add_argument('taxonomy_csv_path')
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()
    result = check_taxonomy_csv(args.taxonomy_csv_path)
    errors = (len(result['taxon_level_errors']) +
              len(result['scientific_name_errors']) +
              len(result['ambiguous_parent_nodes']) +
              (1 if result['cycle'] else 0))
    sys.exit(1 if errors else 0)


if __name__ == '__main__':
    main()
