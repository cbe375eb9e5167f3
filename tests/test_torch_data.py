"""The port's host data path against catseg_tpu's, on the CPU.

catseg_tpu decodes and resizes through the imaging library (PIL, which
bundles libjpeg-turbo); the port decodes with its own C++ library and
resizes in numpy.  Every decoded array, every resize and every train sample
must be bit-equal to catseg_tpu's on the same files, and every refused
image variant must raise NotImplementedError naming the feature.
"""

import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from catseg_tpu.data import loader as jloader
from catseg_tpu.data import mapper as jmapper

from catseg_tpu_torch.data import image_io, loader, mapper, resize
from catseg_tpu_torch.data.catalogs import find_class_json, idmap_path, load_class_names

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"


def _natural(rng, h, w):
    """Smooth colour fields plus noise: JPEG blocks with live AC terms."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 11.0) for c in range(3)], -1)
    return np.clip(base + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


def _png_bytes(w, h, depth, ctype, raw, plte=None, interlace=0):
    def chunk(t, data):
        return struct.pack(">I", len(data)) + t + data + struct.pack(">I", zlib.crc32(t + data) & 0xFFFFFFFF)

    s = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte:
        s += chunk(b"PLTE", plte)
    return s + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _pack_rows(vals, depth):
    """PNG rows (filter byte 0) of sub-byte or 16-bit samples."""
    rows = []
    for row in vals:
        if depth == 16:
            data = row.astype(">u2").tobytes()
        else:
            bits = np.unpackbits(row.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:].reshape(-1)
            data = np.packbits(bits).tobytes()
        rows.append(b"\x00" + data)
    return b"".join(rows)


JPEG_SIZES = [(1, 1), (17, 33), (37, 53), (64, 48)]
JPEG_CASES = (
    [("rgb", q, sub, "") for q in (50, 75, 95) for sub in (0, 1, 2)]
    + [("rgb", 75, sub, "progressive") for sub in (0, 1, 2)]
    + [("rgb", 75, sub, "restart") for sub in (0, 2)]
    + [("rgb", 90, 2, "progressive+restart"), ("grey", 75, 0, ""), ("grey", 75, 0, "progressive")]
)


def _write_jpeg(path, rng, kind, q, sub, extra, hw):
    img = _natural(rng, *hw)
    kw = {"quality": q}
    if kind == "grey":
        im = Image.fromarray(img[..., 0], "L")
    else:
        im = Image.fromarray(img)
        kw["subsampling"] = sub
    if "progressive" in extra:
        kw["progressive"] = True
    if "restart" in extra:
        kw["restart_marker_blocks"] = 4
    im.save(path, "JPEG", **kw)


def _write_pngs(d: Path, rng):
    """{name: path} of PNG variants (PIL-written, and hand-made where PIL
    writes no such file)."""
    out = {}
    a = rng.randint(0, 256, (23, 31, 4)).astype(np.uint8)
    for mode, arr in [("L", a[..., 0]), ("RGB", a[..., :3]), ("RGBA", a), ("LA", a[..., :2])]:
        p = d / f"{mode}.png"
        Image.fromarray(arr, mode).save(p)
        out[mode] = p
    pal = Image.fromarray(rng.randint(0, 200, (23, 31)).astype(np.uint8), "P")
    pal.putpalette(list(rng.randint(0, 256, 3 * 150).astype(np.uint8)))  # indices past 150: black
    pal.save(d / "P.png")
    out["P"] = d / "P.png"
    small = Image.fromarray(rng.randint(0, 4, (9, 13)).astype(np.uint8), "P")
    small.putpalette([10, 20, 30, 40, 50, 60, 70, 80, 90, 1, 2, 3])   # PIL writes this at 2 bits
    small.save(d / "P2bit.png")
    out["P2bit"] = d / "P2bit.png"
    Image.fromarray((rng.randint(0, 70000, (19, 21)) % 65536).astype(np.uint16)).save(d / "I16.png")
    out["I16"] = d / "I16.png"
    Image.fromarray(rng.randint(0, 300, (19, 21)).astype(np.uint16)).save(d / "I16low.png")   # RGB clip at 255
    out["I16low"] = d / "I16low.png"
    # hand-made: 16-bit RGB / RGBA / LA, 1-, 2- and 4-bit grey, all five filters
    for name, depth, ctype, spp in [("RGB16", 16, 2, 3), ("RGBA16", 16, 6, 4), ("LA16", 16, 4, 2)]:
        v = rng.randint(0, 65536, (7, 5, spp))
        (d / f"{name}.png").write_bytes(_png_bytes(5, 7, depth, ctype, _pack_rows(v.reshape(7, -1), 16)))
        out[name] = d / f"{name}.png"
    for depth in (1, 2, 4):
        v = rng.randint(0, 1 << depth, (6, 11))
        (d / f"L{depth}bit.png").write_bytes(_png_bytes(11, 6, depth, 0, _pack_rows(v, depth)))
        out[f"L{depth}bit"] = d / f"L{depth}bit.png"
    # PIL's encoder picks its filters adaptively on large images; a photo
    # with gradients exercises Sub / Up / Average / Paeth
    Image.fromarray(_natural(rng, 67, 83)).save(d / "filters.png", optimize=True)
    out["filters"] = d / "filters.png"
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode")
    rng = np.random.RandomState(0)
    out = {}
    for kind, q, sub, extra in JPEG_CASES:
        for hw in JPEG_SIZES:
            p = d / f"{kind}_q{q}_s{sub}_{extra or 'base'}_{hw[0]}x{hw[1]}.jpg"
            _write_jpeg(p, rng, kind, q, sub, extra, hw)
            out[p.stem] = p
    out.update(_write_pngs(d, rng))
    t = rng.randint(0, 65536, (13, 17)).astype(np.uint16)
    Image.fromarray(t).save(d / "gt16.tif", "TIFF")
    Image.fromarray(t.astype(np.uint8)).save(d / "gt8.tif", "TIFF")
    Image.fromarray(_natural(rng, 13, 17)).save(d / "rgb.tif", "TIFF")
    out.update({"gt16.tif": d / "gt16.tif", "gt8.tif": d / "gt8.tif", "rgb.tif": d / "rgb.tif"})
    return out


JPEG_IDS = [f"{k}_q{q}_s{s}_{e or 'base'}" for k, q, s, e in JPEG_CASES]
PNG_IDS = ["L", "RGB", "RGBA", "LA", "P", "P2bit", "I16", "I16low", "RGB16", "RGBA16", "LA16", "L1bit", "L2bit",
           "L4bit", "filters"]


@pytest.mark.parametrize("case", JPEG_IDS)
def test_jpeg_decode_bit_equal(files, case):
    for hw in JPEG_SIZES:
        p = str(files[f"{case}_{hw[0]}x{hw[1]}"])
        got, want = loader.load_image(p), jloader.load_image(p)
        assert got.dtype == np.uint8 and got.shape == want.shape == (*hw, 3)
        assert np.array_equal(got, want), (p, int((got != want).sum()))
        assert np.array_equal(loader.load_gt(p), jloader.load_gt(p))


@pytest.mark.parametrize("sampling", ["411", "420", "422", "440", "444"])
def test_jpeg_sampling_factors_bit_equal(tmp_path, sampling):
    """h1v2 (4:4:0) and h4v1 (4:1:1), which PIL does not write, through
    OpenCV's libjpeg-turbo encoder; progressive with restarts too."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(3)
    for hw in [(1, 1), (2, 9), (9, 2), (17, 33), (37, 53)]:
        for prog in (0, 1):
            ok, enc = cv2.imencode(".jpg", _natural(rng, *hw), [
                cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, prog,
                cv2.IMWRITE_JPEG_RST_INTERVAL, 3 * prog,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")])
            p = tmp_path / f"{hw}_{prog}.jpg"
            p.write_bytes(enc.tobytes())
            assert np.array_equal(loader.load_image(str(p)), jloader.load_image(str(p))), (hw, prog)


def test_jpeg_noise_at_extreme_qualities(tmp_path):
    """Uniform noise at quality 1 and 100: coefficients at both ends."""
    rng = np.random.RandomState(4)
    for q in (1, 100):
        for sub in (0, 2):
            for prog in (False, True):
                p = tmp_path / f"n{q}{sub}{prog}.jpg"
                Image.fromarray(rng.randint(0, 256, (33, 47, 3), dtype=np.uint8)).save(
                    p, quality=q, subsampling=sub, progressive=prog)
                assert np.array_equal(loader.load_image(str(p)), jloader.load_image(str(p)))


@pytest.mark.parametrize("name", PNG_IDS)
def test_png_decode_bit_equal(files, name):
    p = str(files[name])
    got, want = loader.load_image(p), jloader.load_image(p)
    assert got.shape == want.shape and np.array_equal(got, want)
    got_gt, want_gt = loader.load_gt(p), jloader.load_gt(p)
    assert got_gt.dtype == want_gt.dtype == np.int32 and np.array_equal(got_gt, want_gt)
    with Image.open(p) as im:
        raw = np.asarray(im)
    assert np.array_equal(image_io.decode_array(p), raw)


@pytest.mark.parametrize("name", ["gt16.tif", "gt8.tif", "rgb.tif"])
def test_tiff_decode_bit_equal(files, name):
    p = str(files[name])
    assert np.array_equal(loader.load_gt(p), jloader.load_gt(p))
    assert np.array_equal(loader.load_image(p), jloader.load_image(p))
    with Image.open(p) as im:
        want = np.asarray(im)
    got = image_io.decode_array(p)
    assert got.dtype == want.dtype.newbyteorder("=") and np.array_equal(got, want)


def test_tiff_big_endian(tmp_path):
    t = np.random.RandomState(5).randint(0, 65536, (9, 11)).astype(np.uint16)
    p = tmp_path / "be.tif"
    Image.fromarray(t.astype(">u2")).save(p, "TIFF")
    assert p.read_bytes()[:2] == b"MM"
    assert np.array_equal(loader.load_gt(str(p)), jloader.load_gt(str(p)))


def test_probe_sizes_match_the_reference(files, tmp_path):
    paths = [str(p) for p in files.values()]
    want = jloader.probe_sizes(paths)
    assert loader.probe_sizes(paths) == want
    cache = str(tmp_path / "cache" / "sizes.json")
    assert loader.probe_sizes(paths, cache_path=cache) == want
    assert json.load(open(cache)) == {Path(p).name: list(s) for p, s in zip(paths, want)}
    # the JAX package's cache file serves the port, and the other way round
    jcache = str(tmp_path / "jcache.json")
    jloader.probe_sizes(paths, cache_path=jcache)
    assert loader.probe_sizes(paths, cache_path=jcache) == want


def _jpeg(tmp_path, name="x.jpg", **kw):
    p = tmp_path / name
    Image.fromarray(_natural(np.random.RandomState(6), 24, 40)).save(p, "JPEG", **kw)
    return p


def _patched(p: Path, marker: int, new: int | None = None, offset: int = 0, value: int | None = None):
    data = bytearray(p.read_bytes())
    i = data.index(bytes([0xFF, marker]))
    if new is not None:
        data[i + 1] = new
    if value is not None:
        data[i + offset] = value
    p.write_bytes(bytes(data))
    return str(p)


def _truncated_progressive(tmp_path):
    """A progressive file cut after its first two scans (DC and one AC band):
    libjpeg would smooth the blocks of its missing coefficients."""
    data = _jpeg(tmp_path, "p.jpg", progressive=True).read_bytes()
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    p = tmp_path / "cut.jpg"
    p.write_bytes(data[:sos[2]] + b"\xff\xd9")
    return str(p)


REFUSED = {
    "arithmetic": (lambda t: _patched(_jpeg(t), 0xC0, new=0xC9), "arithmetic"),
    "12-bit": (lambda t: _patched(_jpeg(t), 0xC0, offset=4, value=12), "12-bit"),
    "lossless": (lambda t: _patched(_jpeg(t), 0xC0, new=0xC3), "lossless"),
    "hierarchical": (lambda t: _patched(_jpeg(t), 0xC0, new=0xC5), "hierarchical"),
    "cmyk": (lambda t: (Image.fromarray(_natural(np.random.RandomState(7), 16, 16)).convert("CMYK")
                        .save(t / "c.jpg"), str(t / "c.jpg"))[1], "CMYK"),
    "progressive-incomplete": (_truncated_progressive, "not fully sent"),
    "png-interlaced": (lambda t: ((t / "i.png").write_bytes(_png_bytes(4, 4, 8, 0, b"\x00" * 20, interlace=1)),
                                  str(t / "i.png"))[1], "interlaced"),
    "tiff-compressed": (lambda t: (Image.fromarray(np.zeros((8, 8), np.uint8)).save(
        t / "z.tif", compression="tiff_adobe_deflate"), str(t / "z.tif"))[1], "compression"),
}


@pytest.mark.parametrize("variant", sorted(REFUSED))
def test_refused_variants_raise(tmp_path, variant):
    make, feature = REFUSED[variant]
    p = make(tmp_path)
    with pytest.raises(NotImplementedError, match=feature) as e:
        loader.load_image(p)
    assert p in str(e.value)


def test_dc_huffman_symbol_above_15_raises(tmp_path):
    """A DC symbol is a bit count: libjpeg refuses one above 15, so PIL (and
    catseg_tpu) raises; the port raises ValueError, not garbage pixels."""
    p = _jpeg(tmp_path)
    data = p.read_bytes()
    i = data.index(bytes([0xFF, 0xC4]))
    assert data[i + 4] == 0x00 and data[i + 21] == 0   # the first DHT is DC table 0, first symbol 0
    _patched(p, 0xC4, offset=21, value=0x20)
    with pytest.raises(OSError):
        jloader.load_image(str(p))
    with pytest.raises(ValueError, match="Huffman"):
        loader.load_image(str(p))


def test_exif_orientation_is_ignored(tmp_path):
    """The JAX package's np.asarray(im.convert("RGB")) ignores EXIF
    orientation; so does the port."""
    exif = Image.Exif()
    exif[0x0112] = 6
    p = _jpeg(tmp_path, "o.jpg", exif=exif.tobytes())
    got = loader.load_image(str(p))
    assert got.shape == (24, 40, 3) and np.array_equal(got, jloader.load_image(str(p)))


RESIZE_SHAPES = [(480, 640), (512, 683), (333, 500), (122, 640), (1200, 90), (37, 53)]


@pytest.mark.parametrize("short,max_size", [(640, 2560), (384, 1333), (200, 300), (1200, 4000)])
def test_resize_shortest_edge_bit_equal(short, max_size):
    rng = np.random.RandomState(short)
    for h, w in RESIZE_SHAPES:
        img = _natural(rng, h, w)
        got = loader.resize_shortest_edge(img, short, max_size)
        want = jloader.resize_shortest_edge(img, short, max_size)
        assert got.shape == want.shape and np.array_equal(got, want), (h, w)
        assert np.array_equal(resize.resize_bilinear_u8_numpy(img, want.shape[:2]), want)   # the C++ one's spec
        grey = img[..., 0]
        want = np.asarray(Image.fromarray(grey).resize(want.shape[1::-1], Image.BILINEAR))
        assert np.array_equal(resize.resize_bilinear_u8(grey, want.shape), want)
        assert np.array_equal(resize.resize_bilinear_u8_numpy(grey, want.shape), want)


@pytest.mark.parametrize("pair", [((512, 512), (384, 384)), ((480, 640), (384, 512)), ((333, 500), (1200, 1802)),
                                  ((37, 53), (100, 7)), ((640, 427), (384, 256)), ((1, 5), (3, 2)),
                                  ((768, 1024), (640, 853))])
def test_gt_nearest_bit_equal(pair):
    (h, w), hw = pair
    gt = np.random.RandomState(h + w).randint(0, 65536, (h, w)).astype(np.int32)
    got = mapper._resize_gt(gt, hw)
    assert got.dtype == np.int32 and np.array_equal(got, jmapper._resize_gt(gt, hw))
    assert np.array_equal(loader.resize_shortest_edge(gt, min(hw), 10 ** 6, interp="nearest"),
                          jmapper._resize_gt(gt, loader.shortest_edge_size(h, w, min(hw), 10 ** 6)))


def test_nearest_running_sum_differs_from_closed_form():
    """Why the running sum: the closed form floor((i + 0.5) * a) is another
    function at 512 -> 384."""
    a = 512 / 384
    closed = np.floor((np.arange(384) + 0.5) * a).astype(np.int64)
    assert (resize._nearest_index(512, 384) != closed).any()


@pytest.fixture(scope="module")
def train_pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    rng = np.random.RandomState(8)
    pairs = []
    for i, (h, w) in enumerate([(300, 420), (410, 290), (200, 700)]):
        Image.fromarray(_natural(rng, h, w)).save(d / f"{i}.jpg", quality=90)
        gt = rng.randint(0, 171, (h, w)).astype(np.uint8)
        gt[: h // 5] = 255
        Image.fromarray(gt).save(d / f"{i}.png")
        pairs.append((str(d / f"{i}.jpg"), str(d / f"{i}.png")))
    return pairs


@pytest.mark.parametrize("seed", [0, 1])
def test_train_sample_bit_equal(train_pairs, seed):
    for img_p, gt_p in train_pairs:
        kw = dict(crop_size=384, min_size=(320, 384, 448))
        got = mapper.train_sample(img_p, gt_p, np.random.default_rng(seed), **kw)
        want = jmapper.train_sample(img_p, gt_p, np.random.default_rng(seed), **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


def test_train_batches_bit_equal(train_pairs):
    got = mapper.train_batches(train_pairs, 2, np.random.default_rng(3), crop_size=128)
    want = jmapper.train_batches(train_pairs, 2, np.random.default_rng(3), crop_size=128)
    for _ in range(3):
        (gi, gg), (wi, wg) = next(got), next(want)
        assert np.array_equal(gi, wi) and np.array_equal(gg, wg)


def test_color_aug_matches_the_reference():
    img = _natural(np.random.RandomState(9), 40, 50).astype(np.float32)
    for seed in range(8):
        got = mapper.color_aug_ssd(img.copy(), np.random.default_rng(seed))
        assert np.array_equal(got, jmapper.color_aug_ssd(img.copy(), np.random.default_rng(seed)))


def test_prefetcher_yields_in_order():
    assert list(loader.Prefetcher(list(range(20)), lambda x: x * 2, depth=3)) == [x * 2 for x in range(20)]


def test_prefetcher_propagates_worker_exception():
    def load(i):
        if i == 3:
            raise FileNotFoundError("corrupt.png")
        return i

    it = iter(loader.Prefetcher(list(range(10)), load, depth=2))
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(FileNotFoundError, match="corrupt.png"):
        next(it)


def test_generator_prefetcher():
    pf = loader.GeneratorPrefetcher(iter(range(10)))
    assert [next(pf) for _ in range(10)] == list(range(10))
    pf.close()

    def inf():
        i = 0
        while True:
            yield i
            i += 1

    pf = loader.GeneratorPrefetcher(inf())
    assert next(pf) == 0 and next(pf) == 1
    pf.close()
    pf._t.join(timeout=5.0)
    assert not pf._t.is_alive()

    def bad():
        yield 1
        raise ValueError("corrupt sample")

    pf = loader.GeneratorPrefetcher(bad())
    assert next(pf) == 1
    with pytest.raises(ValueError, match="corrupt sample"):
        next(pf)


def test_catalogs_match_the_reference():
    from catseg_tpu.data import catalogs as jcat

    from catseg_tpu_torch.data import catalogs as tcat

    assert {k: v.__dict__ for k, v in tcat.DATASETS.items()} == {k: v.__dict__ for k, v in jcat.DATASETS.items()}
    assert tcat.BENCHMARKS == jcat.BENCHMARKS
    for name in list(tcat.BENCHMARKS) + ["coco_2017_train_stuff_all_sem_seg"]:
        spec = tcat.get_dataset(name)
        assert load_class_names(spec.class_json) == jcat.load_class_names(spec.class_json)
        if spec.idmap_json:
            assert json.load(open(idmap_path(spec.idmap_json))) == json.load(
                open(Path(jcat.__file__).parent / "idmaps" / spec.idmap_json))
    assert "catseg_tpu_torch" in find_class_json("ade150.json")


def test_class_json_search_order(tmp_path, monkeypatch):
    from catseg_tpu_torch.configs import class_names

    (tmp_path / "ade150.json").write_text(json.dumps(["a", "b"]))
    monkeypatch.setenv("CATSEG_CLASS_JSONS", str(tmp_path))
    assert load_class_names("ade150.json") == ["a", "b"] == class_names("ade150")
    monkeypatch.delenv("CATSEG_CLASS_JSONS")
    assert len(class_names("ade150")) == 150


def test_host_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile, or no g++, raises."""
    (tmp_path / "bad.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(image_io, "HOST_SRC", tmp_path)
    monkeypatch.setattr(image_io, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*bad.cpp"):
        image_io.build_host()
    monkeypatch.setattr(image_io.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        image_io.build_host()


def test_host_library_goes_to_the_build_dir():
    lib = image_io.build_host()
    assert lib.parent.parent == image_io.BUILD_ROOT and lib.parent.name.startswith("host-")


# ---------------------------------------------------------------- fixtures


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def test_committed_fixture_digests_match_the_reference_library():
    """tests/torch_fixtures/digests.json holds the sha256 of the imaging
    library's decoded arrays (and of one resize); chip_smoke checks the
    port's decoder against them on the card's machine, which has no such
    library.  Re-derived here so they cannot drift."""
    digests = json.loads((FIXTURES / "digests.json").read_text())
    assert digests["files"]
    for rel, want in digests["files"].items():
        p = str(FIXTURES / rel)
        with Image.open(p) as im:
            assert _sha(np.asarray(im.convert("RGB"))) == want["rgb"], rel
            assert list(np.asarray(im).shape) == want["shape"], rel
        assert _sha(jloader.load_gt(p)) == want["gt"], rel
        assert _sha(loader.load_image(p)) == want["rgb"] and _sha(loader.load_gt(p)) == want["gt"], rel
    rel, short, max_size = digests["resize"]["file"], *digests["resize"]["short_max"]
    img = jloader.load_image(str(FIXTURES / rel))
    want = jloader.resize_shortest_edge(img, short, max_size)
    assert _sha(want) == digests["resize"]["sha256"]
    assert _sha(loader.resize_shortest_edge(loader.load_image(str(FIXTURES / rel)), short, max_size)) == \
        digests["resize"]["sha256"]
