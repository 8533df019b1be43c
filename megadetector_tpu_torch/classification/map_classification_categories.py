"""
Map a trained classifier's output categories onto a desired target
category set.

Reference contract (megadetector/classification/
map_classification_categories.py:1-60): given two label-spec JSONs (the
desired targets and the spec the classifier was trained with), each
classifier category maps to the target whose matched label set contains
it as a subset; any partial intersection is an error; unassigned
classifier categories group into "other" (the desired spec must not
define a target named "other"). Outputs {target: [classifier
categories]} — the input format of aggregate_classifier_probs.

Membership is resolved through the same spec semantics as
json_validator.parse_spec: (dataset, dataset_label) inclusion pairs,
with taxa expanded against the provided taxonomy.

The port's own copy of
megadetector_tpu/classification/map_classification_categories.py: the same
public names, signatures, defaults and output bytes. The pair route
(map_classification_categories) needs no networkx; the TaxonNode route
(parse_spec) imports it at first use and, without it, raises an ImportError
that names it.
"""

import argparse
import json
import sys

from collections import defaultdict

from megadetector_tpu_torch.classification.json_validator import \
    parse_spec as _parse_label_spec
from megadetector_tpu_torch.taxonomy_mapping.taxonomy_graph import \
    _networkx


def map_classification_categories(desired_spec, classifier_spec,
                                  taxonomy=None):
    """
    Returns {target_name: [classifier category names]} incl. 'other'.
    Raises ValueError on partial overlap.
    """

    assert 'other' not in desired_spec, \
        'the desired spec must not define a target named "other"'

    target_pairs = {t: _parse_label_spec(t, s, taxonomy)
                    for t, s in desired_spec.items()}
    category_pairs = {c: _parse_label_spec(c, s, taxonomy)
                      for c, s in classifier_spec.items()}

    mapping = {t: [] for t in desired_spec}
    other = []
    for category, c_pairs in category_pairs.items():
        assigned = None
        for target, t_pairs in target_pairs.items():
            inter = c_pairs & t_pairs
            if not inter:
                continue
            if c_pairs <= t_pairs:
                if assigned is not None:
                    raise ValueError(
                        'classifier category {} is a subset of both '
                        '{} and {}'.format(category, assigned, target))
                assigned = target
            else:
                raise ValueError(
                    'classifier category {} partially intersects '
                    'target {}: {}'.format(category, target,
                                           sorted(inter)[:5]))
        if assigned is not None:
            mapping[assigned].append(category)
        else:
            other.append(category)

    mapping = {t: sorted(cats) for t, cats in mapping.items()}
    if other:
        mapping['other'] = sorted(other)
    return mapping


#%% TaxonNode-based spec resolution
#
# The reference resolves label specs against the taxonomy *graph*
# (TaxonNode sets, megadetector/classification/
# map_classification_categories.py:114-236) rather than (dataset, label)
# pairs; both views are provided here. These operate on
# taxonomy_graph.TaxonNode objects.


def parse_spec(spec_dict, taxon_to_node, label_to_node):
    """
    Resolve one label spec to the set of TaxonNodes it selects
    (reference: map_classification_categories.py:153-197): each entry in
    spec_dict['taxa'] ((level, name), case-insensitive) and each
    (dataset, dataset_label) in spec_dict['dataset_labels'] contributes
    its node and all graph descendants; spec_dict['exclude'] is a nested
    spec whose nodes are subtracted. Unknown taxa are skipped with a
    warning; an empty result raises ValueError.
    """

    nx = _networkx()

    result = set()
    if 'taxa' in spec_dict:
        for taxon in spec_dict['taxa']:
            key = (taxon['level'].lower(), taxon['name'].lower())
            if key in taxon_to_node:
                node = taxon_to_node[key]
                result.add(node)
                result |= nx.descendants(node.graph, node)
            else:
                print('Taxon {} not found in taxonomy graph. '
                      'Ignoring.'.format(key))
    if 'dataset_labels' in spec_dict:
        for ds, ds_labels in spec_dict['dataset_labels'].items():
            ds = ds.lower()
            for ds_label in ds_labels:
                node = label_to_node[(ds, ds_label.lower())]
                result.add(node)
                result |= nx.descendants(node.graph, node)
    if 'exclude' in spec_dict:
        result -= parse_spec(spec_dict['exclude'], taxon_to_node,
                             label_to_node)
    if len(result) == 0:
        raise ValueError(
            'specification matched no TaxonNode: {}'.format(spec_dict))
    return result


def label_spec_to_nodes(label_spec_js, taxon_to_node, label_to_node):
    """
    Convert a label-spec JSON dict to {label: set of TaxonNodes}
    (reference: map_classification_categories.py:200-236). Raises
    ValueError when two labels select overlapping node sets.
    """

    seen_nodes = set()
    label_to_nodes = {}
    for label, spec_dict in label_spec_js.items():
        include_set = parse_spec(spec_dict, taxon_to_node, label_to_node)
        if include_set.isdisjoint(seen_nodes):
            label_to_nodes[label] = include_set
            seen_nodes |= include_set
        else:
            for label_b, set_b in label_to_nodes.items():
                shared = include_set.intersection(set_b)
                if len(shared) > 0:
                    print('Labels {} and {} share nodes: {}'.format(
                        label, label_b, shared))
                    raise ValueError('Intersection between sets!')
    return label_to_nodes


def map_target_to_classifier(target_label_to_nodes,
                             classifier_label_to_nodes):
    """
    Assign each classifier category to the target whose node set
    contains it (reference:
    map_classification_categories.py:114-150): full containment maps,
    partial overlap raises ValueError, and categories contained by no
    target collect under 'other'. Returns {target: sorted [classifier
    labels]}.
    """

    remaining_classifier_labels = set(classifier_label_to_nodes.keys())
    target_to_classifier_labels = defaultdict(set)
    for target, target_nodes in target_label_to_nodes.items():
        for label, classifier_nodes in classifier_label_to_nodes.items():
            overlap = classifier_nodes & target_nodes
            if len(overlap) == len(classifier_nodes):
                target_to_classifier_labels[target].add(label)
                remaining_classifier_labels.discard(label)
            elif 0 < len(overlap) < len(classifier_nodes):
                raise ValueError(
                    'Only partial overlap between target {} and '
                    'classifier label {}'.format(target, label))
    if len(remaining_classifier_labels) > 0:
        target_to_classifier_labels['other'] = \
            remaining_classifier_labels
    return {target: sorted(labels_set)
            for target, labels_set in
            sorted(target_to_classifier_labels.items())}


def main():
    parser = argparse.ArgumentParser(
        description='Map classifier categories onto target categories')
    parser.add_argument('desired_spec_json')
    parser.add_argument('classifier_spec_json')
    parser.add_argument('output_json')
    parser.add_argument('--taxonomy_csv', default=None)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    with open(args.desired_spec_json) as f:
        desired = json.load(f)
    with open(args.classifier_spec_json) as f:
        classifier = json.load(f)
    taxonomy = None
    if args.taxonomy_csv is not None:
        from megadetector_tpu_torch.taxonomy_mapping.taxonomy_graph import \
            build_taxonomy_from_csv
        taxonomy = build_taxonomy_from_csv(args.taxonomy_csv)
    mapping = map_classification_categories(desired, classifier,
                                            taxonomy)
    with open(args.output_json, 'w') as f:
        json.dump(mapping, f, indent=1)
    print('Wrote mapping for {} targets to {}'.format(
        len(mapping), args.output_json))


if __name__ == '__main__':
    main()
