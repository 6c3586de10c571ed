"""The port's PNG codec (``mvdetr_tpu_torch/data/png.py`` and the native
``png_unfilter``) against cv2 and PIL, the decoders the JAX package reads
frames with: on PNGs that they write, the bytes must be equal (PNG is
lossless, so any correct decoder gives the same pixels). The corpus holds
random and smooth RGB, RGBA and grey images written by cv2 at compression 0,
3 and 9 (libpng's adaptive filter choice) and by PIL with ``optimize``; the
test reads the filter byte of every row to show that it holds all five
filter types."""

import io
import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from mvdetr_tpu_torch.data import adapters  # noqa: E402
from mvdetr_tpu_torch.data.png import decode_png, encode_png, read_chunks  # noqa: E402


def _images():
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:61, 0:83]
    smooth = np.stack([(x * 3 + y) % 256, (y * 4) % 256, ((x + y) * 2) % 256], -1).astype(np.uint8)
    # a smooth field with mild noise: rows where Average and Paeth predict best
    gradient = np.clip(np.stack([x * 2.0 + y, x + y * 2.0, (x + y) * 1.5], -1) + rng.normal(0, 2, (61, 83, 3)),
                       0, 255).astype(np.uint8)
    random = rng.integers(0, 256, (47, 29, 3), dtype=np.uint8)
    return {"random": random, "smooth": smooth, "gradient": gradient}


def _corpus():
    """``(label, png bytes, expected RGB)``: each image as RGB, RGBA and
    grey, written by cv2 (compression 0, 3, 9) and by PIL (optimize)."""
    rng = np.random.default_rng(1)
    out = []
    for name, rgb in _images().items():
        alpha = rng.integers(0, 256, rgb.shape[:2], dtype=np.uint8)
        grey = rgb[:, :, 1].copy()
        for form, img, expected in (("rgb", rgb, rgb), ("rgba", np.dstack([rgb, alpha]), rgb),
                                    ("grey", grey, np.repeat(grey[:, :, None], 3, 2))):
            bgr = img if img.ndim == 2 else img[:, :, [2, 1, 0, 3][:img.shape[2]]]
            for level in (0, 3, 9):
                ok, buf = cv2.imencode(".png", bgr, [cv2.IMWRITE_PNG_COMPRESSION, level])
                assert ok
                out.append((f"{name}-{form}-cv2-{level}", buf.tobytes(), expected))
            bio = io.BytesIO()
            Image.fromarray(img).save(bio, format="PNG", optimize=True)
            out.append((f"{name}-{form}-pil", bio.getvalue(), expected))
        bio = io.BytesIO()
        Image.fromarray(np.dstack([grey, alpha]), mode="LA").save(bio, format="PNG")
        out.append((f"{name}-grey-alpha-pil", bio.getvalue(), np.repeat(grey[:, :, None], 3, 2)))
    return out


def _filter_types(data: bytes) -> set:
    """The filter type byte of every row of an 8-bit non-interlaced PNG."""
    chunks = list(read_chunks(data))
    width, height, _, colour, _, _, _ = struct.unpack(">IIBBBBB", chunks[0][1])
    row = 1 + width * {0: 1, 2: 3, 4: 2, 6: 4}[colour]
    raw = zlib.decompress(b"".join(payload for kind, payload in chunks if kind == b"IDAT"))
    return set(raw[::row][:height])


def test_decode_png_is_bitwise_cv2_and_pil_on_a_corpus_of_all_five_filters():
    corpus = _corpus()
    filters = set()
    for label, data, expected in corpus:
        ours = decode_png(data)
        via_cv2 = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1]
        with Image.open(io.BytesIO(data)) as im:
            via_pil = np.asarray(im.convert("RGB"))
        assert ours.dtype == np.uint8 and ours.shape == expected.shape, label
        assert np.array_equal(ours, via_cv2), label
        assert np.array_equal(ours, via_pil), label
        assert np.array_equal(ours, expected), label
        filters |= _filter_types(data)
    assert filters == {0, 1, 2, 3, 4}, f"the corpus holds filter types {sorted(filters)}"


@pytest.mark.parametrize("shape", [(33, 57), (33, 57, 3), (33, 57, 4)])
def test_encode_png_round_trips_through_cv2_and_pil(shape):
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    data = encode_png(img)
    rgb = img if img.ndim == 3 else img[:, :, None]
    rgb = np.repeat(rgb, 3, 2) if rgb.shape[2] == 1 else rgb[:, :, :3]
    assert np.array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1], rgb)
    with Image.open(io.BytesIO(data)) as im:
        assert np.array_equal(np.asarray(im), img)
    assert np.array_equal(decode_png(data), rgb)
    assert _filter_types(data) == {0}


def _patched_header(data: bytes, **fields) -> bytes:
    """``data`` with IHDR fields replaced and its CRC recomputed."""
    names = ("width", "height", "depth", "colour", "compression", "filtering", "interlace")
    values = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])), **fields)
    header = struct.pack(">IIBBBBB", *(values[n] for n in names))
    return data[:16] + header + struct.pack(">I", zlib.crc32(b"IHDR" + header)) + data[33:]


def test_unsupported_and_corrupt_pngs_raise():
    img = np.random.default_rng(3).integers(0, 256, (16, 24, 3), dtype=np.uint8)
    bio = io.BytesIO()
    Image.fromarray(img).convert("P").save(bio, format="PNG")
    with pytest.raises(ValueError, match="palette"):
        decode_png(bio.getvalue())
    ok, buf = cv2.imencode(".png", img.astype(np.uint16) * 257)
    assert ok
    with pytest.raises(ValueError, match="16-bit"):
        decode_png(buf.tobytes())
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(_patched_header(encode_png(img), interlace=1))
    data = bytearray(encode_png(img))
    data[50] ^= 0xFF  # a byte inside IDAT
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"\xff\xd8\xff" + bytes(data[3:]))


def test_load_image_rgb_never_hands_a_png_to_cv2_or_pil(tmp_path, monkeypatch):
    """``.png`` goes through ``decode_png`` even where cv2 and PIL are
    installed; a JPEG still takes cv2."""
    img = np.random.default_rng(4).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    png = tmp_path / "f.png"
    png.write_bytes(encode_png(img))
    jpg = tmp_path / "f.jpg"
    cv2.imwrite(str(jpg), img[:, :, ::-1])

    def refuse(*args, **kw):
        raise AssertionError("cv2 was asked to decode")

    monkeypatch.setattr(cv2, "imread", refuse)
    assert np.array_equal(adapters.load_image_rgb(str(png)), img)
    with pytest.raises(AssertionError, match="cv2 was asked"):
        adapters.load_image_rgb(str(jpg))


def _unfilter_reference(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The PNG specification's reconstruction (section 9), one byte at a time."""
    out = np.zeros((height, row_bytes), np.uint8)
    for y in range(height):
        kind, row = raw[y * (row_bytes + 1)], raw[y * (row_bytes + 1) + 1:(y + 1) * (row_bytes + 1)]
        for i in range(row_bytes):
            a = int(out[y, i - bpp]) if i >= bpp else 0
            b = int(out[y - 1, i]) if y else 0
            c = int(out[y - 1, i - bpp]) if y and i >= bpp else 0
            p = a + b - c
            paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) else (b if abs(p - b) <= abs(p - c)
                                                                                    else c)
            pred = (0, a, b, (a + b) // 2, paeth)[kind]
            out[y, i] = (row[i] + pred) % 256
    return out


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_png_unfilter_matches_the_specification(bpp):
    from mvdetr_tpu_torch import native

    rng = np.random.default_rng(bpp)
    height, row_bytes = 9, 7 * bpp
    rows = rng.integers(0, 256, (height, row_bytes + 1), dtype=np.uint8)
    rows[:, 0] = rng.permutation(np.resize(np.arange(5), height))  # every filter type, first rows included
    raw = rows.tobytes()
    np.testing.assert_array_equal(native.png_unfilter(raw, height, row_bytes, bpp),
                                  _unfilter_reference(raw, height, row_bytes, bpp))
    rows[4, 0] = 5
    with pytest.raises(ValueError, match="filter type"):
        native.png_unfilter(rows.tobytes(), height, row_bytes, bpp)
    with pytest.raises(ValueError, match="bytes for"):
        native.png_unfilter(raw[:-1], height, row_bytes, bpp)
