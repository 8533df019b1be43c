"""
Shared inputs for the port's host-tool tests and for chip_smoke.py's
phase 41 (numpy and the standard library only): seeded GBIF and iNat
taxonomy archives in the forms species_lookup reads, and the clustering
rule of native.cluster_boxes stated in Python.
"""

import os

import numpy as np

_TAXON_SYLLABLES = ('ca', 'lo', 'mi', 'ru', 'te', 'pha', 'nor', 'vul', 'sci',
                    'dax', 'ori', 'bel', 'gus', 'tan', 'pel', 'qui')
_TAXON_COLORS = ('white', 'black', 'red', 'spotted', 'striped', 'long')
_TAXON_BODIES = ('tailed', 'backed', 'eared', 'necked')


def taxonomy_archives(folder, rng, n_genera=40, per_genus=6):
    """GBIF (backbone.zip: Taxon.tsv, VernacularName.tsv) and iNat
    (inaturalist-taxonomy.dwca.zip: taxa.csv, VernacularNames-english.csv)
    archives, the basenames of species_lookup.TAXONOMY_URLS, in [folder]:
    Animalia ('animal'), Homo sapiens ('person'), a plant kingdom, and a
    seeded mammal class of orders, families, [n_genera] genera and
    [per_genus] species each, about 60 % with an English vernacular
    ('<color>-<body> <word>'), some with a French one. Returns ({English
    vernacular: scientific name}, [species names], the taxa count)."""

    import zipfile

    def word(n):
        return ''.join(_TAXON_SYLLABLES[i] for i in
                       rng.randint(0, len(_TAXON_SYLLABLES), n))

    gbif = [('1', '', 'Animalia', 'kingdom', 'Animalia'),
            ('2', '1', 'Chordata', 'phylum', 'Animalia'),
            ('3', '2', 'Mammalia', 'class', 'Animalia'),
            ('4', '3', 'Primates', 'order', 'Animalia'),
            ('5', '4', 'Hominidae', 'family', 'Animalia'),
            ('6', '5', 'Homo', 'genus', 'Animalia'),
            ('7', '6', 'Homo sapiens', 'species', 'Animalia'),
            ('8', '', 'Plantae', 'kingdom', 'Plantae'),
            ('9', '8', 'Quercus', 'genus', 'Plantae')]
    vern = [('1', 'animal', 'en'), ('7', 'person', 'en'),
            ('7', 'humain', 'fr')]
    commons, species = {}, []
    next_id = [100]

    def new_id():
        next_id[0] += 1
        return str(next_id[0])

    families = []
    for _ in range(4):
        order_id = new_id()
        gbif.append((order_id, '3', word(3).capitalize() + 'ia', 'order',
                     'Animalia'))
        for _ in range(2):
            families.append(new_id())
            gbif.append((families[-1], order_id,
                         word(3).capitalize() + 'idae', 'family',
                         'Animalia'))
    used = {'Homo'}
    for i in range(n_genera):
        genus = word(2 + i % 2).capitalize()
        while genus in used:
            genus = word(3).capitalize()
        used.add(genus)
        genus_id = new_id()
        gbif.append((genus_id, families[i % len(families)], genus, 'genus',
                     'Animalia'))
        for _ in range(per_genus):
            name = '{} {}'.format(genus, word(2 + int(rng.randint(0, 2))))
            if name in used:
                continue
            used.add(name)
            sid = new_id()
            gbif.append((sid, genus_id, name, 'species', 'Animalia'))
            species.append(name)
            if rng.rand() < 0.6:
                common = '{}-{} {}'.format(
                    _TAXON_COLORS[rng.randint(len(_TAXON_COLORS))],
                    _TAXON_BODIES[rng.randint(len(_TAXON_BODIES))],
                    word(2))
                if common not in commons:
                    commons[common] = name
                    vern.append((sid, common, 'en'))
            if rng.rand() < 0.3:
                vern.append((sid, word(3), 'fr'))
    inat_ids = {r[0]: str(int(r[0]) + 5000) for r in gbif
                if r[4] == 'Animalia'}
    inat = [(inat_ids[t], 'https://www.inaturalist.org/taxa/' +
             inat_ids[p] if p else '', k, n, rank)
            for t, p, n, rank, k in gbif if k == 'Animalia']
    with zipfile.ZipFile(os.path.join(folder, 'backbone.zip'), 'w') as z:
        z.writestr('Taxon.tsv', 'taxonID\tparentNameUsageID\tcanonicalName'
                   '\ttaxonRank\tkingdom\n' + ''.join(
                       '\t'.join(r) + '\n' for r in gbif))
        z.writestr('VernacularName.tsv', 'taxonID\tvernacularName\t'
                   'language\n' + ''.join('\t'.join(r) + '\n' for r in vern))
    with zipfile.ZipFile(os.path.join(
            folder, 'inaturalist-taxonomy.dwca.zip'), 'w') as z:
        z.writestr('taxa.csv', 'id,parentNameUsageID,kingdom,scientificName,'
                   'taxonRank\n' + ''.join(','.join(r) + '\n' for r in inat))
        z.writestr('VernacularNames-english.csv', 'id,vernacularName\n' +
                   ''.join('{},{}\n'.format(inat_ids[t], v)
                           for t, v, lang in vern if lang == 'en'))
    return commons, species, len(gbif)


def cluster_rule(boxes_xywh, categories, iou_thres,
                  category_agnostic=False):
    """native.cluster_boxes' rule in Python, in float32 as the C++
    computes it: each box in input order joins the first seed of its
    category (of any, when [category_agnostic]) with IoU >= iou_thres
    found over the 0.05 grid cells its box covers (rows, then columns,
    then the seeds in the order they were registered in the cell); else
    it seeds a new cluster, registered in those cells. Returns (cluster
    ids, count)."""

    f = np.float32
    cell = f(0.05)
    grid_n = int(f(1.0) / cell) + 2
    grid, seeds, seed_cats, out = {}, [], [], []

    def iou(a, b):
        iw = max(f(0), min(a[2], b[2]) - max(a[0], b[0]))
        ih = max(f(0), min(a[3], b[3]) - max(a[1], b[1]))
        inter = f(iw * ih)
        union = f(f((a[2] - a[0]) * (a[3] - a[1])) +
                  f((b[2] - b[0]) * (b[3] - b[1]))) - inter
        return f(inter / union) if union > 0 else f(0)

    for i, (x, y, w, h) in enumerate(np.asarray(boxes_xywh, np.float32)):
        box = (x, y, f(x + w), f(y + h))
        cells = [cy * grid_n + cx
                 for cy in range(max(0, int(y / cell)),
                                 min(grid_n - 1, int(f(y + h) / cell)) + 1)
                 for cx in range(max(0, int(x / cell)),
                                 min(grid_n - 1, int(f(x + w) / cell)) + 1)]
        assigned = next((s for c in cells for s in grid.get(c, ())
                         if (category_agnostic or
                             seed_cats[s] == categories[i]) and
                         iou(box, seeds[s]) >= f(iou_thres)), -1)
        if assigned < 0:
            assigned = len(seeds)
            seeds.append(box)
            seed_cats.append(int(categories[i]))
            for c in cells:
                grid.setdefault(c, []).append(assigned)
        out.append(assigned)
    return out, len(seeds)
