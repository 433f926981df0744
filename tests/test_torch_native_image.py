"""The port's image loader (captionax_torch/data/native_image.py) against
captionax's, on the same bytes: PNG (RGB, gray, palette, RGBA, 16-bit
gray), JPEG (baseline, progressive, gray) and corrupt bytes.

Each function runs on both routes: the native decoder ``csrc/imgdec.cc``
(the port builds its own copy of the library from that source) and PIL,
the route of a machine where the library cannot be built (forced by
marking both modules' loads as failed).  Where both sides take the same
route the arrays must be exactly equal; the port's native JPEG decode
against captionax's PIL route stays within tests/test_native_image.py's
JPEG bound of 2 per channel."""

import io

import numpy as np
import pytest
from PIL import Image

from captionax.data import native_image as cni
from captionax_torch.data import native_image as tni

JPEG_BOUND = 2  # tests/test_native_image.py: native libjpeg vs PIL's libjpeg-turbo
HW = (24, 32)


def _encode(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _rgb(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


def _blobs():
    rs = np.random.RandomState(7)
    g16 = (rs.rand(18, 22) * 65535).astype("<u2")
    return {
        "png_rgb": _encode(Image.fromarray(_rgb(37, 53, 0)), "PNG"),
        "png_gray": _encode(Image.fromarray(rs.randint(0, 256, (30, 41), np.uint8)), "PNG"),
        "png_palette": _encode(Image.fromarray(_rgb(25, 31, 1)).quantize(64), "PNG"),
        "png_rgba": _encode(Image.fromarray(rs.randint(0, 256, (20, 20, 4), np.uint8), "RGBA"),
                            "PNG"),
        "png_gray16": _encode(Image.fromarray(g16), "PNG"),  # mode I;16
        "jpeg": _encode(Image.fromarray(_rgb(48, 64, 2)), "JPEG", quality=92),
        "jpeg_progressive": _encode(Image.fromarray(_rgb(40, 40, 3)), "JPEG", quality=88,
                                    progressive=True),
        "jpeg_gray": _encode(Image.fromarray(rs.randint(0, 256, (33, 27), np.uint8)), "JPEG"),
    }


BLOBS = _blobs()
GRAY = ("png_gray", "png_gray16", "jpeg_gray")
ROUTES = ("native", "pil")


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """Both modules on the native decoder (skipped where neither builds it)
    or both on PIL."""
    if request.param == "pil":
        for mod in (cni, tni):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_LOAD_FAILED", True)
    elif not (tni.native_available() and cni.native_available()):
        pytest.skip("the native image library does not build here (no libjpeg/libpng)")
    return request.param


def _viridis_differs(gray_mode):
    """Without matplotlib the PIL route replicates gray where the native
    library applies its baked-in LUT."""
    if gray_mode != tni.GRAY_VIRIDIS:
        return False
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return True
    return False


def test_native_available_agrees():
    assert tni.native_available() == cni.native_available()
    assert (tni.GRAY_REPLICATE, tni.GRAY_VIRIDIS) == (cni.GRAY_REPLICATE, cni.GRAY_VIRIDIS)


@pytest.mark.parametrize("name", sorted(BLOBS))
def test_decode(route, name):
    got = tni.decode(BLOBS[name])
    np.testing.assert_array_equal(got, cni.decode(BLOBS[name]))
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3


@pytest.mark.parametrize("name", sorted(GRAY))
def test_decode_viridis(route, name):
    if route == "pil" and _viridis_differs(tni.GRAY_VIRIDIS):
        pytest.skip("matplotlib is not installed: the PIL route replicates gray")
    got = tni.decode(BLOBS[name], gray_mode=tni.GRAY_VIRIDIS)
    np.testing.assert_array_equal(got, cni.decode(BLOBS[name], gray_mode=cni.GRAY_VIRIDIS))


@pytest.mark.parametrize("gray_mode", (0, 1), ids=("replicate", "viridis"))
@pytest.mark.parametrize("name", sorted(BLOBS))
def test_decode_resize(route, name, gray_mode):
    if route == "pil" and name in GRAY and _viridis_differs(gray_mode):
        pytest.skip("matplotlib is not installed: the PIL route replicates gray")
    got = tni.decode_resize(BLOBS[name], HW, gray_mode)
    assert got.shape == HW + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, cni.decode_resize(BLOBS[name], HW, gray_mode))


def test_native_jpeg_within_the_pil_bound(monkeypatch):
    """The port's native JPEG decode against captionax's PIL route: close,
    not bit-identical (two libjpeg builds); PNG is lossless and exact."""
    if not tni.native_available():
        pytest.skip("the native image library does not build here (no libjpeg/libpng)")
    native = {n: tni.decode(BLOBS[n]) for n in ("jpeg", "jpeg_progressive", "png_rgb")}
    monkeypatch.setattr(cni, "_LIB", None)
    monkeypatch.setattr(cni, "_LOAD_FAILED", True)
    for name, got in native.items():
        ref = cni.decode(BLOBS[name])
        assert got.shape == ref.shape
        bound = JPEG_BOUND if name.startswith("jpeg") else 0
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= bound, name


@pytest.mark.parametrize("threads", (0, 1, 3))
def test_decode_resize_batch(route, threads):
    blobs = [BLOBS[n] for n in sorted(BLOBS)]
    got = tni.decode_resize_batch(blobs, HW, threads=threads)
    assert got.shape == (len(blobs),) + HW + (3,)
    np.testing.assert_array_equal(got, cni.decode_resize_batch(blobs, HW, threads=threads))
    for i, b in enumerate(blobs):
        np.testing.assert_array_equal(got[i], tni.decode_resize(b, HW))
    assert tni.decode_resize_batch([], HW).shape == (0,) + HW + (3,)


def test_batch_redecodes_only_refused_rows(route):
    """A BMP the native decoder refuses (negative status) is decoded again
    by PIL in its own row; the other rows keep the native result."""
    bmp = _encode(Image.fromarray(_rgb(19, 23, 4)), "BMP")
    blobs = [BLOBS["png_rgb"], bmp, BLOBS["jpeg"]]
    got = tni.decode_resize_batch(blobs, HW, threads=2)
    np.testing.assert_array_equal(got, cni.decode_resize_batch(blobs, HW, threads=2))
    np.testing.assert_array_equal(got[1], cni._pil_decode_resize(bmp, HW, 0))


def test_corrupt_bytes_raise(route):
    from PIL import UnidentifiedImageError

    for fn in (tni.decode, lambda b: tni.decode_resize(b, HW),
               lambda b: tni.decode_resize_batch([BLOBS["png_rgb"], b], HW)):
        with pytest.raises(UnidentifiedImageError):
            fn(b"not an image at all")


def test_make_file_loader(route, tmp_path):
    for name, data in BLOBS.items():
        (tmp_path / f"{name}.img").write_bytes(data)
    port = tni.make_file_loader(str(tmp_path), HW)
    ref = cni.make_file_loader(str(tmp_path), HW)
    viridis = tni.make_file_loader(str(tmp_path), HW, tni.GRAY_VIRIDIS)
    for name in BLOBS:
        np.testing.assert_array_equal(port(f"{name}.img"), ref(f"{name}.img"))
        if name in GRAY and not (route == "pil" and _viridis_differs(tni.GRAY_VIRIDIS)):
            np.testing.assert_array_equal(
                viridis(f"{name}.img"), cni.decode_resize(BLOBS[name], HW, cni.GRAY_VIRIDIS))


def test_load_paths_batch(route, tmp_path):
    paths = []
    for name, data in sorted(BLOBS.items()):
        path = tmp_path / f"{name}.img"
        path.write_bytes(data)
        paths.append(str(path))
    got = tni.load_paths_batch(paths, HW, threads=2)
    np.testing.assert_array_equal(got, cni.load_paths_batch(paths, HW, threads=2))
    np.testing.assert_array_equal(got, tni.decode_resize_batch([BLOBS[n] for n in sorted(BLOBS)],
                                                               HW))


def test_no_decoder_raises(monkeypatch):
    """With no native library and no PIL, decoding raises."""
    import sys

    monkeypatch.setattr(tni, "_LIB", None)
    monkeypatch.setattr(tni, "_LOAD_FAILED", True)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        tni.decode_resize(BLOBS["png_rgb"], HW)
    with pytest.raises(ImportError):
        tni.decode_resize_batch([BLOBS["jpeg"]], HW)
