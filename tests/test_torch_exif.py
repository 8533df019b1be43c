"""
The port's EXIF reader (ReadExifOptions, _clean_value and read_pil_exif,
as the batch driver imports them from megadetector_tpu_torch/utils/
read_exif.py, which re-exports data_management/read_exif.py) against the JAX
package's megadetector_tpu/data_management/read_exif.py on the same JPEGs:
IFD0 and Exif sub-IFD tags, GPS, rationals, bytes under each
byte_handling, tag filters, an image without EXIF and a file that is no
image.
"""

import pytest
from PIL import Image, TiffImagePlugin

from megadetector_tpu.data_management import read_exif as jax_exif
from megadetector_tpu_torch.utils import read_exif


def _jpeg(path, exif=None):
    img = Image.new('RGB', (64, 48), (120, 30, 200))
    kwargs = {'quality': 90}
    if exif is not None:
        kwargs['exif'] = exif.tobytes()
    img.save(str(path), **kwargs)
    return str(path)


def _rich_exif():
    exif = Image.Exif()
    exif[271] = 'TestCam'                       # Make
    exif[306] = '2022:03:04 05:06:07'           # DateTime
    exif[274] = 6                               # Orientation
    exif[282] = TiffImagePlugin.IFDRational(72, 1)
    sub = exif.get_ifd(0x8769)
    sub[36867] = '2022:03:04 05:06:07'          # DateTimeOriginal
    sub[33434] = TiffImagePlugin.IFDRational(1, 250)  # ExposureTime
    sub[37510] = b'ASCII\x00\x00\x00user comment'  # UserComment
    gps = exif.get_ifd(0x8825)
    gps[1] = 'N'
    gps[2] = (TiffImagePlugin.IFDRational(47, 1),
              TiffImagePlugin.IFDRational(30, 1),
              TiffImagePlugin.IFDRational(0, 1))
    return exif


@pytest.fixture(scope='module')
def jpegs(tmp_path_factory):
    root = tmp_path_factory.mktemp('exif')
    return {'rich': _jpeg(root / 'rich.jpg', _rich_exif()),
            'plain': _jpeg(root / 'plain.jpg'),
            'broken': str(root / 'broken.jpg')}


@pytest.mark.parametrize('byte_handling', ['convert_to_string', 'delete',
                                           'raw'])
def test_read_pil_exif_matches_jax(jpegs, byte_handling):
    ours_options = read_exif.ReadExifOptions()
    ref_options = jax_exif.ReadExifOptions()
    assert vars(ours_options) == vars(ref_options)
    ours_options.byte_handling = ref_options.byte_handling = byte_handling
    for source in ('path', 'image'):
        f = jpegs['rich']
        ours = read_exif.read_pil_exif(
            f if source == 'path' else Image.open(f), ours_options)
        ref = jax_exif.read_pil_exif(
            f if source == 'path' else Image.open(f), ref_options)
        assert ours == ref
        assert ours['Make'] == 'TestCam'
        assert ours['DateTimeOriginal'] == '2022:03:04 05:06:07'
        assert ours['ExposureTime'] == 0.004
        assert ours['GPSLatitude'] == (47.0, 30.0, 0.0)


def test_tag_filters_match_jax(jpegs):
    for field, tags in (('tags_to_include', ['Make', 'Orientation']),
                        ('tags_to_exclude', ['Make', 'GPSLatitude'])):
        ours_options = read_exif.ReadExifOptions()
        ref_options = jax_exif.ReadExifOptions()
        setattr(ours_options, field, tags)
        setattr(ref_options, field, tags)
        ours = read_exif.read_pil_exif(jpegs['rich'], ours_options)
        assert ours == jax_exif.read_pil_exif(jpegs['rich'], ref_options)
    assert sorted(read_exif.read_pil_exif(jpegs['rich'], ours_options)) == \
        sorted(ours)


def test_no_exif_and_no_image(jpegs):
    assert read_exif.read_pil_exif(jpegs['plain']) == \
        jax_exif.read_pil_exif(jpegs['plain']) == {}
    with open(jpegs['broken'], 'wb') as f:
        f.write(b'no image')
    for reader in (read_exif.read_pil_exif, jax_exif.read_pil_exif):
        with pytest.raises(Exception):
            reader(jpegs['broken'])
    # A rotated copy keeps only IFD0 (no sub-IFD flattening), in both
    img = Image.open(jpegs['rich']).rotate(90, expand=True)
    assert read_exif.read_pil_exif(img) == jax_exif.read_pil_exif(img)


@pytest.mark.parametrize('value', [
    b'caf\xc3\xa9', b'\xff\xfe', TiffImagePlugin.IFDRational(3, 4),
    TiffImagePlugin.IFDRational(1, 0), (b'a', TiffImagePlugin.IFDRational(
        1, 2), 3), 'text', 7, None])
def test_clean_value_matches_jax(value):
    for handling in ('convert_to_string', 'delete', 'raw'):
        ours = read_exif._clean_value(value, handling)
        ref = jax_exif._clean_value(value, handling)
        assert repr(ours) == repr(ref)
