"""
EXIF reading for the batch driver: ReadExifOptions, _clean_value and
read_pil_exif, kept at this path for the batch driver and its callers.
The code lives in megadetector_tpu_torch/data_management/read_exif.py,
the port's copy of the whole EXIF module; this re-exports it. PIL is
imported only when a file or image is read.
"""

from megadetector_tpu_torch.data_management.read_exif import (  # noqa: F401
    ReadExifOptions, _clean_value, read_pil_exif)
