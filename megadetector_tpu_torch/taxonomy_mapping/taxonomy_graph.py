"""
The port's copy of megadetector_tpu/taxonomy_mapping/taxonomy_graph.py
(no device code). networkx is imported where a graph is built, not with
the module, so everything else of the port runs without it; without it a
taxonomy graph raises an ImportError that names networkx.

Taxonomy graph utilities: build a DAG of taxa (kingdom -> ... -> species),
walk ancestors/descendants, and map arbitrary dataset labels onto
canonical taxa.

Behavioral contract follows the reference
(megadetector/taxonomy_mapping/taxonomy_graph.py:65-346): networkx-backed
TaxonNode objects that support multiple parents, dataset-label
accumulation, build_taxonomy_graph over the LILA taxonomy-mapping CSV,
and dag_to_tree. The repo's TaxonomyGraph convenience wrapper (simple
id-indexed taxonomies, any iterable of (taxon_id, level, name,
parent_id) rows) is layered on the same node class.
"""

import ast
import json

from collections import defaultdict, deque



def _networkx():
    """networkx, imported at first use: the rest of the port runs without
    it (the card's machine is not promised it), and only a taxonomy graph
    needs it."""

    try:
        import networkx
    except ImportError as e:
        raise ImportError(
            'networkx is required for taxonomy graphs (--taxonomy_file, '
            'taxonomy_mapping/taxonomy_graph.py) but is not installed: '
            '{}'.format(e)) from e
    return networkx


class TaxonNode:
    """
    A node in a taxonomy graph (DAG), associated with a set of dataset
    labels (reference: taxonomy_graph.py:65-185). Parents/children live
    in the attached networkx DiGraph, so multiple parents are
    supported; `parent` is a single-parent convenience view used by the
    TaxonomyGraph wrapper.
    """

    #: When True, add_parent() refuses a second distinct parent
    single_parent_only = False

    def __init__(self, level, name, graph=None, taxon_id=None,
                 parent_id=None):
        self.level = level
        self.name = name
        self.graph = graph if graph is not None else _networkx().DiGraph()
        # Register immediately so isolated nodes (no edges yet) are
        # still members of the graph — descendants() on a fresh node
        # must return the empty set, not raise
        self.graph.add_node(self)
        self.ids = set()
        self.dataset_labels = set()
        # TaxonomyGraph-wrapper extras
        self.taxon_id = taxon_id
        self.parent_id = parent_id

    def __repr__(self):
        id_str = ', '.join('{}={}'.format(source, taxon_id)
                           for source, taxon_id in sorted(self.ids))
        return 'TaxonNode({}, level={}, name={})'.format(
            id_str, self.level, self.name)

    @property
    def parents(self):
        assert self.graph is not None
        if self not in self.graph:
            return []
        return list(self.graph.predecessors(self))

    @parents.setter
    def parents(self, parents):
        assert self.graph is not None
        for p in self.parents:
            self.graph.remove_edge(p, self)
        for p in parents:
            self.graph.add_edge(p, self)

    @property
    def parent(self):
        """First parent or None (single-parent convenience view)."""

        parents = self.parents
        return parents[0] if parents else None

    @property
    def children(self):
        assert self.graph is not None
        if self not in self.graph:
            return []
        return list(self.graph.successors(self))

    @children.setter
    def children(self, children):
        assert self.graph is not None
        for c in self.children:
            self.graph.remove_edge(self, c)
        for c in children:
            self.graph.add_edge(self, c)

    def add_id(self, source, taxon_id):
        """Record this taxon's id in [source] (e.g. 'gbif', 'inat')."""

        self.ids.add((source, taxon_id))

    def add_parent(self, parent):
        """
        Add [parent] (a higher taxon) as a parent of this node
        (reference: taxonomy_graph.py:126-144).
        """

        assert self.graph is not None
        assert parent.graph is self.graph, \
            'Parent and child must share a graph'
        parents = self.parents
        if TaxonNode.single_parent_only and len(parents) > 0:
            assert len(parents) == 1
            assert parents[0] is parent, \
                'self.parents: {}, new parent: {}'.format(parents,
                                                          parent)
            return
        if parent not in parents:
            self.graph.add_edge(parent, self)

    def add_child(self, child):
        """Add [child] (a lower taxon) as a child of this node."""

        assert self.graph is not None
        assert child.graph is self.graph, \
            'Parent and child must share a graph'
        self.graph.add_edge(self, child)

    def add_dataset_label(self, ds, ds_label):
        """Associate the (dataset, dataset_label) pair with this taxon."""

        self.dataset_labels.add((ds, ds_label))

    def get_dataset_labels(self, include_datasets=None):
        """
        All (ds, ds_label) tuples belonging to this taxon or its
        descendants, optionally restricted to [include_datasets]
        (reference: taxonomy_graph.py:166-185).
        """

        result = self.dataset_labels
        if include_datasets is not None:
            result = set(tup for tup in result
                         if tup[0] in include_datasets)
        for child in self.children:
            result = result | child.get_dataset_labels(include_datasets)
        return result

    @classmethod
    def lowest_common_ancestor(cls, nodes):
        """
        Lowest common ancestor of [nodes], or None (reference:
        taxonomy_graph.py:187-219): intersect every node's
        path-to-root set, then return the member none of whose children
        is also in the intersection.
        """

        paths = []
        for node in nodes:
            path = {node}
            remaining = list(node.parents)
            while remaining:
                x = remaining.pop()
                if x not in path:
                    path.add(x)
                    remaining += x.parents
            paths.append(path)
        intersect = set.intersection(*paths)

        for node in intersect:
            if intersect.isdisjoint(node.children):
                return node
        return None


def build_taxonomy_graph(taxonomy_df):
    """
    Build the taxonomy DAG from the LILA taxonomy-mapping table
    (columns dataset_name, query, taxonomy_level, scientific_name,
    taxonomy_string, optional source); returns (graph, taxon_to_node,
    label_to_node) with all keys lowercased (reference:
    taxonomy_graph.py:224-292). taxonomy_string rows are
    list-of-(id, level, name, common) ancestries, lowest taxon first;
    rows without one are skipped. Accepts a DataFrame or a list of row
    dicts.
    """

    if hasattr(taxonomy_df, 'iterrows'):
        rows = (row for _, row in taxonomy_df.iterrows())
    else:
        rows = iter(taxonomy_df)

    graph = _networkx().DiGraph()
    taxon_to_node = {}
    label_to_node = {}
    for row in rows:
        ds = row['dataset_name'].lower()
        ds_label = row['query'].lower()
        # Empty source cells read as float NaN from pandas (truthy!) —
        # only a non-empty string overrides the default
        id_source = row['source'] if 'source' in row and \
            isinstance(row['source'], str) and row['source'] else 'inat'
        taxa_ancestry = row['taxonomy_string']
        if taxa_ancestry is None or (not isinstance(taxa_ancestry, str)
                                     and taxa_ancestry != taxa_ancestry):
            # NaN/None: excluded from the graph (can still appear in a
            # label spec via dataset_labels)
            continue
        if isinstance(taxa_ancestry, str):
            # The reference uses eval(); these are literal tuples
            taxa_ancestry = ast.literal_eval(taxa_ancestry)

        taxon_child = None
        for i, taxon in enumerate(taxa_ancestry):
            taxon_id, taxon_level, taxon_name = taxon[:3]
            taxon_level = taxon_level.lower()
            taxon_name = taxon_name.lower()

            key = (taxon_level, taxon_name)
            if key not in taxon_to_node:
                taxon_to_node[key] = TaxonNode(level=taxon_level,
                                               name=taxon_name,
                                               graph=graph)
                graph.add_node(taxon_to_node[key])
            node = taxon_to_node[key]

            if taxon_child is not None:
                node.add_child(taxon_child)
            node.add_id(id_source, int(taxon_id))
            if i == 0:
                # Compare case-insensitively: taxon_level/taxon_name
                # were lowercased above, and capitalized CSV cells are
                # semantically identical
                assert row['taxonomy_level'].lower() == taxon_level, \
                    'taxonomy CSV level: {}, level from ' \
                    'taxonomy_string: {}'.format(row['taxonomy_level'],
                                                 taxon_level)
                assert row['scientific_name'].lower() == taxon_name
                node.add_dataset_label(ds, ds_label)
                label_to_node[(ds, ds_label)] = node
            taxon_child = node

    assert _networkx().is_directed_acyclic_graph(graph)
    return graph, taxon_to_node, label_to_node


def dag_to_tree(graph, taxon_to_node):
    """
    Convert the taxonomy DAG to a tree by keeping, for every
    multi-parent node, only its lowest parent (reference:
    taxonomy_graph.py:295-346; the reference hardcodes four taxa whose
    two parents are incomparable — here any incomparable pair raises
    instead, since those fixups are dataset-release specific). The
    output may have several disconnected components; check
    networkx.is_tree() per component.
    """

    tree = _networkx().DiGraph()
    for node in graph.nodes:
        tree.add_node(node)
        parents = node.parents
        if len(parents) == 1:
            tree.add_edge(parents[0], node)
        elif len(parents) >= 2:
            placed = False
            for p_low in parents:
                others = [p for p in parents if p is not p_low]
                if all(p_low in _networkx().descendants(graph, p)
                       for p in others):
                    tree.add_edge(p_low, node)
                    placed = True
                    break
            assert placed, \
                'Node {} has incomparable parents {}; resolve the ' \
                'taxonomy upstream'.format(node, parents)

    for node in tree.nodes:
        node.graph = tree
    return tree


class TaxonomyGraph:
    """DAG over TaxonNode objects with name and id indices."""

    def __init__(self, rows=None):
        self.graph = _networkx().DiGraph()
        self.id_to_node = {}
        self.name_to_nodes = defaultdict(list)
        if rows is not None:
            for row in rows:
                self.add_node(*row)
            self.link()

    @classmethod
    def from_file(cls, path):
        """
        Load a taxonomy from disk: .json ([[id, level, name, parent_id],
        ...] or {'rows': [...]}) or .csv with columns
        id,level,name,parent_id (header optional).
        """

        import json as _json

        rows = []
        if str(path).endswith('.json'):
            with open(path) as f:
                data = _json.load(f)
            rows = data['rows'] if isinstance(data, dict) else data
        else:
            import csv
            with open(path, newline='') as f:
                for rec in csv.reader(f):
                    if not rec or rec[0].strip().lower() in ('id',
                                                             'taxon_id'):
                        continue
                    parent = rec[3].strip() if len(rec) > 3 and \
                        rec[3].strip() else None
                    rows.append((rec[0].strip(), rec[1].strip(),
                                 rec[2].strip(), parent))
        return cls(rows=rows)

    def add_node(self, taxon_id, level, name, parent_id=None):
        node = TaxonNode(level, str(name).lower(), graph=self.graph,
                         taxon_id=taxon_id, parent_id=parent_id)
        self.graph.add_node(node)
        assert taxon_id not in self.id_to_node, \
            'Duplicate taxon id {}'.format(taxon_id)
        self.id_to_node[taxon_id] = node
        self.name_to_nodes[node.name].append(node)
        return node

    def link(self):
        """Resolve parent_id references into graph edges."""

        for node in self.id_to_node.values():
            if node.parent_id is not None and \
                    node.parent_id in self.id_to_node:
                node.add_parent(self.id_to_node[node.parent_id])

    def find(self, name):
        """Nodes whose name matches (case-insensitive)."""

        return self.name_to_nodes.get(str(name).lower(), [])

    def ancestors(self, node):
        """Ancestor chain, nearest first (single-parent view)."""

        out = []
        cur = node.parent
        while cur is not None:
            out.append(cur)
            cur = cur.parent
        return out

    def descendants(self, node):
        """All descendants (BFS order)."""

        out = []
        queue = deque(node.children)
        while queue:
            cur = queue.popleft()
            out.append(cur)
            queue.extend(cur.children)
        return out

    def lowest_common_ancestor(self, node_a, node_b):
        """LCA of two nodes, or None."""

        return TaxonNode.lowest_common_ancestor([node_a, node_b])

    def map_to_allowed(self, name, allowed_names):
        """
        Map a taxon name to itself or its nearest ancestor within
        [allowed_names]; None when no ancestor qualifies.
        """

        allowed = set(str(a).lower() for a in allowed_names)
        name = str(name).lower()
        if name in allowed:
            return name
        for node in self.find(name):
            for ancestor in self.ancestors(node):
                if ancestor.name in allowed:
                    return ancestor.name
        return None

    def to_parent_chain_file(self, output_file):
        """
        Write {name: [ancestor names...]} JSON, the format consumed by
        classification_postprocessing.restrict_to_taxa_list.
        """

        chains = {}
        for node in self.id_to_node.values():
            chains[node.name] = [a.name for a in self.ancestors(node)]
        with open(output_file, 'w') as f:
            json.dump(chains, f, indent=1)
        return chains


def build_taxonomy_from_csv(csv_file, id_col='taxon_id', level_col='level',
                            name_col='name', parent_col='parent_id'):
    """Build a TaxonomyGraph from a CSV taxonomy table."""

    import csv
    rows = []
    with open(csv_file, newline='') as f:
        for row in csv.DictReader(f):
            parent = row.get(parent_col) or None
            rows.append((row[id_col], row.get(level_col, ''),
                         row[name_col], parent))
    return TaxonomyGraph(rows)
