"""
Location-level train/val splitting for camera-trap datasets (reference:
megadetector/utils/split_locations_into_train_val.py:26): randomly split
locations into train/val many times and keep the seed that satisfies
per-category error constraints while minimizing the weighted sum of each
category's divergence from the target val fraction.

The port's own copy of
megadetector_tpu/utils/split_locations_into_train_val.py: the same public
names, signatures, defaults and output bytes.
"""

import random


def split_locations_into_train_val(location_to_category_counts,
                                   n_random_seeds=10000,
                                   target_val_fraction=0.15,
                                   category_to_max_allowable_error=None,
                                   category_to_error_weight=None,
                                   default_max_allowable_error=0.1,
                                   require_complete_coverage=True,
                                   verbose=False):
    """
    Args:
        location_to_category_counts: {location_id: {category: count}}
        n_random_seeds: seeds to try, starting from zero
        target_val_fraction: desired per-category val fraction
        category_to_max_allowable_error: hard per-category constraints
            (error if none of the seeds meets them)
        category_to_error_weight: per-category weights (default 1.0)
        default_max_allowable_error: constraint for categories absent
            from category_to_max_allowable_error (None or >= 1 disables)
        require_complete_coverage: every category must appear in both
            splits

    Returns:
        (val location-id list, {category: achieved val fraction})
    """

    location_ids = sorted(location_to_category_counts.keys())
    n_val_locations = int(target_val_fraction * len(location_ids))
    assert 0 < n_val_locations < len(location_ids), \
        'Cannot make a {}-location val split from {} locations'.format(
            n_val_locations, len(location_ids))

    if category_to_max_allowable_error is None:
        category_to_max_allowable_error = {}
    if category_to_error_weight is None:
        category_to_error_weight = {}

    category_to_count = {}
    for counts in location_to_category_counts.values():
        for category, count in counts.items():
            category_to_count[category] = \
                category_to_count.get(category, 0) + count
    categories = sorted(category_to_count.keys())

    def evaluate(val_ids):
        """(weighted_error, {category: val fraction}) or None when a
        hard constraint fails."""

        val_set = set(val_ids)
        fractions = {}
        weighted_error = 0.0
        for category in categories:
            total = category_to_count[category]
            in_val = sum(
                location_to_category_counts[loc].get(category, 0)
                for loc in val_set)
            fraction = in_val / total if total > 0 else 0.0
            fractions[category] = fraction
            error = abs(fraction - target_val_fraction)
            max_err = category_to_max_allowable_error.get(
                category, default_max_allowable_error)
            if max_err is not None and max_err < 1.0 and \
                    error > max_err:
                return None
            if require_complete_coverage and total > 0 and \
                    (in_val == 0 or in_val == total):
                return None
            weighted_error += error * \
                category_to_error_weight.get(category, 1.0)
        return weighted_error, fractions

    best = None
    for seed in range(n_random_seeds):
        rng = random.Random(seed)
        val_ids = rng.sample(location_ids, n_val_locations)
        result = evaluate(val_ids)
        if result is None:
            continue
        weighted_error, fractions = result
        if best is None or weighted_error < best[0]:
            best = (weighted_error, val_ids, fractions)
            if verbose:
                print('Seed {}: weighted error {:.4f}'.format(
                    seed, weighted_error))

    assert best is not None, \
        'No random seed satisfied the split constraints; relax ' \
        'category_to_max_allowable_error or coverage requirements'
    _, val_ids, fractions = best
    return sorted(val_ids), fractions
