"""
Default integer categories for MegaDetector output boxes (reference:
megadetector/data_management/annotation_constants.py). Integer IDs here;
the MD .json format uses string integers.

The port's own copy of
megadetector_tpu/data_management/annotation_constants.py: the same public
names, signatures, defaults and output bytes.
"""

# MegaDetector output categories (the "empty" category is implicit)
detector_bbox_categories = [
    {'id': 0, 'name': 'empty'},
    {'id': 1, 'name': 'animal'},
    {'id': 2, 'name': 'person'},
    {'id': 3, 'name': 'vehicle'},
]

# Used for choosing colors, so it ignores the "empty" class
NUM_DETECTOR_CATEGORIES = len(detector_bbox_categories) - 1

detector_bbox_category_id_to_name = {
    cat['id']: cat['name'] for cat in detector_bbox_categories}
detector_bbox_category_name_to_id = {
    cat['name']: cat['id'] for cat in detector_bbox_categories}
