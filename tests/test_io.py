"""I/O layer tests: CZI round-trip, tables, output writers."""

import json
import os

import numpy as np
import pandas as pd
import pytest

from hiprfish_tpu.io import czi, images, outputs, tables


def test_czi_roundtrip_single_plane(tmp_path, rng):
    plane = rng.rand(37, 45, 5).astype(np.float32)
    path = str(tmp_path / "x.czi")
    czi.write_czi(path, plane)
    f = czi.CziFile(path)
    assert (f.size_y, f.size_x, f.size_c, f.size_z, f.size_t) == (37, 45, 5, 1, 1)
    got = f.load_plane()
    np.testing.assert_allclose(got, plane, rtol=1e-6)
    assert "ImageDocument" in f.metadata_xml


def test_czi_roundtrip_zstack(tmp_path, rng):
    vol = rng.rand(4, 16, 18, 3).astype(np.float32)  # (Z, Y, X, C)
    path = str(tmp_path / "z.czi")
    czi.write_czi(path, vol)
    f = czi.CziFile(path)
    assert f.size_z == 4
    for z in range(4):
        np.testing.assert_allclose(f.load_plane(z=z), vol[z], rtol=1e-6)
    # io.images integration
    stack = images.load_image_zstack_fixed_t(path)
    assert stack.shape == (16, 18, 4, 3)
    np.testing.assert_allclose(stack[:, :, 2], vol[2], rtol=1e-6)


def test_czi_gray16_normalized(tmp_path, rng):
    plane = (rng.rand(8, 9, 2) * 65535).astype(np.uint16)
    path = str(tmp_path / "g16.czi")
    czi.write_czi(path, plane.astype(np.float32) / 65535.0)
    # also test integer pixel type path
    czi.write_czi(path, plane, pixel_type=1)
    got = czi.CziFile(path).load_plane()
    np.testing.assert_allclose(got, plane / 65535.0, atol=1e-4)


def test_czi_rejects_non_czi(tmp_path):
    path = tmp_path / "bad.czi"
    path.write_bytes(b"not a czi file at all" * 10)
    with pytest.raises(ValueError):
        czi.CziFile(str(path))


def test_load_image_npy(tmp_path, rng):
    arr = rng.rand(10, 12, 4).astype(np.float32)
    p = str(tmp_path / "a.npy")
    np.save(p, arr)
    np.testing.assert_array_equal(images.load_image(p), arr)


def test_workflow_config(tmp_path):
    cfg = {
        "__default__": {"SCRIPTS_PATH": "/s", "DATA_DIR": "/d"},
        "images": {"image_list_table": "/t.csv", "image_type": "M"},
    }
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    wc = tables.WorkflowConfig.from_json(str(p))
    assert wc.data_dir == "/d" and wc.image_type == "M"


def test_parse_encoding_and_fov():
    assert tables.parse_encoding("08_18_2018_enc_37") == 37
    assert tables.parse_fov("mix_0_fov_12") == 12
    assert tables.sample_from_image_name("a_b_enc_5_405.czi") == "a_b_enc_5"


def test_reference_clf_path():
    p = tables.reference_clf_path("/d", "ref", 2000)
    assert p.endswith(
        "reference_simulate_2000_excitation_adjusted_normalized_"
        "violet_derivative_umap_transform.pkl")


def test_reference_clf_path_from_row_convention_tree():
    """Table-driven walk of every branch of the reference's get_reference_clf
    (hiprfish-image-analysis-reference/Snakefile:47-71)."""
    base = {"REFERENCE_FOLDER": "ref", "SPC": 500,
            "INPUT_TAB_FILENAME": "images_table_mix_7.csv"}
    cases = [
        # (row overrides, expected filename)
        ({"REFERENCE_TYPE": "A"}, "reference_all.pkl"),
        ({"REFERENCE_NORMALIZATION": "T", "REFERENCE_SCOPE": "Select"},
         "reference_simulate_select_mix_7_500_normalized_umap_transform.pkl"),
        ({"REFERENCE_NORMALIZATION": "T", "REFERENCE_UMAP": "T"},
         "reference_simulate_500_excitation_adjusted_normalized_"
         "violet_derivative_umap_transform.pkl"),
        ({"REFERENCE_NORMALIZATION": "T", "REFERENCE_UMAP": "F"},
         "reference_simulate_500_normalized_excitation_adjusted.pkl"),
        ({"REFERENCE_NORMALIZATION": "F", "REFERENCE_SCOPE": "Select"},
         "reference_simulate_select_mix_7_500.pkl"),
        ({"REFERENCE_NORMALIZATION": "F"}, "reference_simulate_500.pkl"),
    ]
    for overrides, expected in cases:
        row = dict(base, **overrides)
        p = tables.reference_clf_path_from_row("/d", row)
        assert p == os.path.join("/d", "ref", expected), (overrides, p)
    # Ecoli tables without the dispatch columns resolve to the default branch.
    p = tables.reference_clf_path_from_row(
        "/d", {"REFERENCE_FOLDER": "ref", "SPC": 2000})
    assert p == tables.reference_clf_path("/d", "ref", 2000)
    # Select scope without a mix tag is a hard error, not a silent fallback.
    import pytest
    with pytest.raises(ValueError):
        tables.reference_clf_path_from_row(
            "/d", dict(base, REFERENCE_SCOPE="Select",
                       INPUT_TAB_FILENAME="images_table.csv"))


def test_bvox_export(tmp_path):
    vol = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    p = str(tmp_path / "v.bvox")
    outputs.save_bvox(vol, p)
    raw = open(p, "rb").read()
    header = np.frombuffer(raw[:16], "<i4")
    assert header.tolist() == [2, 3, 4, 1]
    data = np.frombuffer(raw[16:], "<f4")
    np.testing.assert_array_equal(data, vol.flatten("F"))


def test_calibration_cube():
    cal = np.full((4, 4), 2.0, np.float32)
    cube = images.build_calibration_cube(cal, 95, 32)
    assert cube.shape == (4, 4, 95)
    assert (cube[:, :, :32] == 2.0).all()
    assert (cube[:, :, 32:] == 1.0).all()


def test_czi_codec_registry_roundtrip(tmp_path, rng):
    """Codec-compressed subblocks resolve through the decompressor
    registry (an unassigned compression id with a zlib stand-in; the real
    JPEG-XR path through this registry is covered by test_jxr.py)."""
    import zlib

    fake_id = 99
    plane = (rng.rand(31, 29, 3) * 60000).astype(np.uint16).astype(np.float32)
    plane /= 65535.0
    path = str(tmp_path / "jxr.czi")
    czi.write_czi(path, plane, compression=fake_id,
                  compressor=zlib.compress)
    f = czi.CziFile(path)
    # Unregistered codec -> clear, actionable error.
    with pytest.raises(NotImplementedError, match="imagecodecs"):
        f.load_plane()
    try:
        czi.register_decompressor(
            fake_id,
            lambda raw, entry: np.frombuffer(
                zlib.decompress(raw), np.float32
            ).reshape(entry.dim_size("Y"), entry.dim_size("X")))
        got = czi.CziFile(path).load_plane()
        np.testing.assert_allclose(got, plane, rtol=1e-6)
    finally:
        czi._DECOMPRESSORS.pop(fake_id, None)


def test_czi_jpeg_native_decode_roundtrip(tmp_path, rng):
    """Real JPEG-compressed CZI (compression=1) decodes out of the box:
    golden bytes from a PIL encoder, decoded by the native libjpeg path and
    by the registry chain through CziFile.load_plane — io/czi.py's
    unsupported-codec raise must be unreachable for compression=1."""
    import io as _io

    from PIL import Image

    from hiprfish_tpu.io import czi_native

    img = np.zeros((48, 64), np.uint8)
    yy, xx = np.mgrid[:48, :64]
    for cx, cy in [(16, 12), (40, 30), (55, 10)]:
        img[((yy - cy) ** 2 + (xx - cx) ** 2) < 49] = 200
    img += (rng.rand(48, 64) * 10).astype(np.uint8)

    def pil_jpeg_encode(raw_bytes: bytes) -> bytes:
        arr = np.frombuffer(raw_bytes, np.uint8).reshape(48, 64)
        buf = _io.BytesIO()
        Image.fromarray(arr, mode="L").save(buf, "JPEG", quality=95)
        return buf.getvalue()

    path = str(tmp_path / "jpeg.czi")
    # write_czi serializes pixel_type 0 planes as u8; the compressor
    # receives those bytes directly
    czi.write_czi(path, img[:, :, None].astype(np.float32), pixel_type=0,
                  compression=czi.COMP_JPEG, compressor=pil_jpeg_encode)

    got = np.asarray(czi.CziFile(path).load_plane(), np.float32)
    got = got.reshape(48, 64)
    if got.max() <= 1.0:       # u8 planes load 1/255-normalized
        got = got * 255.0
    # JPEG is lossy: demand close, not equal
    assert np.abs(got - img.astype(np.float32)).mean() < 3

    # direct native decode path (when the toolchain built the library)
    buf = _io.BytesIO()
    Image.fromarray(img, mode="L").save(buf, "JPEG", quality=95)
    arr = czi_native.decode_jpeg(buf.getvalue(), (48, 64))
    if arr is not None:
        ref = np.asarray(Image.open(_io.BytesIO(buf.getvalue())))
        assert arr.shape == ref.shape
        # libjpeg vs PIL(-libjpeg-turbo) IDCT may differ by ±1
        assert np.abs(arr.astype(int) - ref.astype(int)).max() <= 1


def test_czi_jpeg_native_assembler(tmp_path, rng):
    """The threaded native assembler (czi_native.load_plane_native) decodes
    JPEG subblocks in C++ via libjpeg."""
    import io as _io

    from PIL import Image

    from hiprfish_tpu.io import czi_native

    if czi_native.get_library() is None:
        pytest.skip("native library unavailable")
    img = (rng.rand(32, 40) * 255).astype(np.uint8)
    img[8:24, 10:30] = 180  # smooth block survives JPEG well

    def enc(raw):
        arr = np.frombuffer(raw, np.uint8).reshape(32, 40)
        buf = _io.BytesIO()
        Image.fromarray(arr, mode="L").save(buf, "JPEG", quality=95)
        return buf.getvalue()

    path = str(tmp_path / "jn.czi")
    czi.write_czi(path, img[:, :, None].astype(np.float32), pixel_type=0,
                  compression=czi.COMP_JPEG, compressor=enc)
    f = czi.CziFile(path)
    got = czi_native.load_plane_native(f)
    assert got is not None
    got = np.asarray(got).reshape(32, 40) * 255.0
    assert np.abs(got[8:24, 10:30] - 180).mean() < 3


# ---------------------------------------------------------------------------
# Robustness: malformed input must raise ValueError (or a clean subclass of
# the documented errors) — never a raw struct.error, an unbounded
# allocation, an out-of-bounds native write, or a hang. The reference
# inherits this hardening from bioformats; the from-scratch parser has to
# prove it (biofilm_analysis.py:55-132 reads arbitrary user CZIs).
# ---------------------------------------------------------------------------

_CLEAN_ERRORS = (ValueError, IndexError, NotImplementedError)


def _make_fixture_czi(tmp_path, rng, compression):
    plane = rng.rand(24, 31, 3).astype(np.float32)
    path = str(tmp_path / f"fix_{compression}.czi")
    czi.write_czi(path, plane, compression=compression)
    return path, plane


def _read_all(path):
    f = czi.CziFile(path)
    try:
        out = f.load_plane()
        f.metadata_xml
        return out
    finally:
        f.close()


@pytest.mark.parametrize("compression",
                         [czi.COMP_UNCOMPRESSED, czi.COMP_ZSTD0])
def test_czi_truncation_sweep(tmp_path, rng, compression):
    """Truncating the file at any point either still reads (truncation past
    the live data) or raises a clean error."""
    path, plane = _make_fixture_czi(tmp_path, rng, compression)
    blob = open(path, "rb").read()
    tpath = str(tmp_path / "trunc.czi")
    # every 173 bytes + the structural boundaries
    cuts = sorted(set(range(0, len(blob), 173))
                  | {0, 1, 31, 32, 63, 64, 511, 512, len(blob) - 1})
    for cut in cuts:
        with open(tpath, "wb") as fh:
            fh.write(blob[:cut])
        try:
            out = _read_all(tpath)
        except _CLEAN_ERRORS:
            continue
        assert out.shape == plane.shape


@pytest.mark.parametrize("compression",
                         [czi.COMP_UNCOMPRESSED, czi.COMP_ZSTD0])
def test_czi_corruption_fuzz(tmp_path, rng, compression):
    """Seeded random byte flips: reads either succeed (possibly with wrong
    pixels — the flip may land in pixel data) or raise a clean error, with
    the native threaded path active so its descriptor validation is
    exercised too."""
    path, plane = _make_fixture_czi(tmp_path, rng, compression)
    blob = bytearray(open(path, "rb").read())
    fuzz_rng = np.random.RandomState(1234)
    fpath = str(tmp_path / "fuzz.czi")
    for _ in range(250):
        corrupt = bytearray(blob)
        for _ in range(fuzz_rng.randint(1, 5)):
            corrupt[fuzz_rng.randint(len(corrupt))] = fuzz_rng.randint(256)
        with open(fpath, "wb") as fh:
            fh.write(bytes(corrupt))
        try:
            out = _read_all(fpath)
        except _CLEAN_ERRORS:
            continue
        # A flip can land in pixel bytes (wrong values) or in a subblock
        # start coordinate (larger mosaic) and still be a structurally
        # valid CZI; success just has to stay sane and bounded.
        assert out.ndim == 3 and min(out.shape) >= 1
        assert out.nbytes < (256 << 20)


def test_czi_zstd_bomb_rejected(tmp_path, rng):
    """A zstd frame that decompresses to far more than the declared plane
    must be rejected, not allocated: the 24x31x3 float32 plane here carries
    a 64 MiB payload."""
    import zstandard

    plane = rng.rand(24, 31, 3).astype(np.float32)
    path = str(tmp_path / "bomb.czi")
    bomb = zstandard.ZstdCompressor().compress(b"\x00" * (64 << 20))
    # zstd1 so write_czi routes through the compressor (zstd0 compresses
    # natively); the leading \x00 is the zstd1 size-byte header.
    czi.write_czi(path, plane, compression=czi.COMP_ZSTD1,
                  compressor=lambda raw: b"\x00" + bomb)
    with pytest.raises(ValueError):
        _read_all(path)


def test_czi_truncated_subblock_data(tmp_path, rng):
    """Cutting inside the pixel payload of the last subblock raises a clean
    truncation error instead of reshaping garbage."""
    path, plane = _make_fixture_czi(tmp_path, rng, czi.COMP_UNCOMPRESSED)
    blob = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(blob[:len(blob) - 200])
    with pytest.raises(_CLEAN_ERRORS):
        _read_all(path)


def test_pixel_size_um_from_zeiss_scaling_xml():
    xml = ("<ImageDocument><Metadata><Scaling><Items>"
           "<Distance Id=\"X\"><Value>6.75e-08</Value></Distance>"
           "<Distance Id=\"Y\"><Value>6.75e-08</Value></Distance>"
           "</Items></Scaling></Metadata></ImageDocument>")
    assert abs(czi.pixel_size_um(xml) - 0.0675) < 1e-12
    assert czi.pixel_size_um("") is None
    assert czi.pixel_size_um("<ImageDocument/>") is None
    assert czi.pixel_size_um("<not xml") is None
    # Value present but unparseable / non-positive -> None, not a crash.
    assert czi.pixel_size_um(
        "<a><Distance Id=\"X\"><Value>zero</Value></Distance></a>") is None
    assert czi.pixel_size_um(
        "<a><Distance Id=\"X\"><Value>-1</Value></Distance></a>") is None


def test_czi_pixel_size_property(tmp_path, rng):
    xml = ("<ImageDocument><Scaling><Items><Distance Id=\"X\">"
           "<Value>1.3e-07</Value></Distance></Items></Scaling>"
           "</ImageDocument>")
    path = str(tmp_path / "scaled.czi")
    czi.write_czi(path, rng.rand(16, 16, 2).astype(np.float32),
                  metadata_xml=xml)
    with czi.CziFile(path) as f:
        assert abs(f.pixel_size_um - 0.13) < 1e-12


def test_identification_png_scale_bar(tmp_path, rng):
    """Figure writers draw the reference's physical scale bar
    (biofilm_analysis.py:245-261): bar present in the lower-right,
    white bar pixels on the identification render."""
    seg = np.zeros((200, 200), np.int32)
    seg[20:60, 20:80] = 1
    sample = str(tmp_path / "fov")
    outputs.save_identification_png(seg, sample, pixel_um=0.0675)
    outputs.save_segmentation(seg, sample, pixel_um=0.0675)
    from PIL import Image

    for name in ("_identification.png", "_seg.png"):
        img = np.asarray(Image.open(sample + name).convert("RGB"))
        h, w = img.shape[:2]
        corner = img[int(h * 0.85):, int(w * 0.55):]
        assert (corner == 255).all(axis=-1).sum() > 50, name
    # nice-length rule: 1/2/5 ladder, <= 28% of field width
    assert outputs._nice_bar_um(200 * 0.0675) == 2.0
    assert outputs._nice_bar_um(2000 * 0.0675) == 20.0
    assert outputs._nice_bar_um(0.0) == 1.0


def test_write_png_roundtrip(tmp_path):
    """The numpy+zlib PNG writer (used where matplotlib is absent) writes
    a standard 8-bit RGB PNG."""
    from PIL import Image

    rgb = np.zeros((17, 23, 3), np.float32)
    rgb[2:5, 3:9] = (1.0, 0.5, 0.0)
    rgb[10:, :4] = (0.2, 0.4, 1.0)
    path = str(tmp_path / "x.png")
    outputs.write_png(path, rgb)
    back = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(
        back, (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8))


def test_seg_png_without_matplotlib(tmp_path, monkeypatch):
    """save_segmentation still writes _seg.png (with the scale bar drawn
    into the pixels) when matplotlib cannot be imported."""
    import builtins

    from PIL import Image

    real_import = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    seg = np.zeros((200, 200), np.int32)
    seg[20:60, 20:80] = 1
    sample = str(tmp_path / "fov")
    outputs.save_segmentation(seg, sample, pixel_um=0.0675)
    img = np.asarray(Image.open(sample + "_seg.png").convert("RGB"))
    assert img.shape == (200, 200, 3)
    corner = img[int(200 * 0.85):, int(200 * 0.55):]
    assert (corner == 255).all(axis=-1).sum() > 50
    assert img[40, 50].any() and not img[5, 5].any()
