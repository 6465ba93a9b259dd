"""The port's PNG codec (pfnl_tpu_torch/native, zlib alone) against the JAX
package's libpng loader (pfnl_tpu.native) and its imread, bitwise, on the
CPU: header sizes, whole and cropped frames, every colour type and bit
depth the format has (gray, gray+alpha, palette, RGB, RGBA; 1 to 16 bits;
the five row filters; Adam7), the encoder read back by both packages,
image_io falling through to the codec where cv2 and PIL do not import,
a failed build raising with g++'s message, the two faults the port
repairs, and TrainPipeline decoding a PNG dataset through the codec into
the JAX pipeline's batches."""

import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from pfnl_tpu import native as jnative
from pfnl_tpu.data.manifest import load_manifest as j_load_manifest
from pfnl_tpu.data.pipeline import TrainPipeline as JTrainPipeline
from pfnl_tpu.utils.image_io import imread as j_imread

from pfnl_tpu_torch import native
from pfnl_tpu_torch.data.frames import PngFrames
from pfnl_tpu_torch.data.manifest import load_manifest
from pfnl_tpu_torch.data.pipeline import TrainPipeline
from pfnl_tpu_torch.utils import image_io
from tests.util_data import make_dataset

# --- a PNG writer in numpy, for the files cv2 cannot write ----------------

ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def _row_bytes(row: np.ndarray, depth: int) -> np.ndarray:
    """One row of samples [W, ch] packed at `depth` bits, big-endian."""
    if depth == 16:
        return np.frombuffer(row.astype(">u2").tobytes(), np.uint8)
    if depth == 8:
        return row.astype(np.uint8).reshape(-1)
    bits = np.unpackbits(row.astype(np.uint8).reshape(-1, 1), axis=1)[:, 8 - depth:]
    return np.packbits(bits.reshape(-1))


def _filter(x: np.ndarray, prev: np.ndarray, kind: int, bpp: int) -> bytes:
    x, prev = x.astype(np.int32), prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (left + prev) // 2
    else:
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    return bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes()


def write_png(path, samples, color, depth, palette=None, interlace=False, extra=()):
    """samples [H,W,ch] raw values (palette indices for colour 3).  Rows
    take the filters 0-4 in turn; the image data is split over two IDAT
    chunks, after the chunks in `extra` ((tag, data) pairs)."""
    h, w = samples.shape[:2]
    bpp = max(1, CHANNELS[color] * depth // 8)
    passes = ADAM7 if interlace else [(0, 0, 1, 1)]
    raw, k = b"", 0
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = np.zeros_like(_row_bytes(sub[0], depth))
        for row in sub:
            packed = _row_bytes(row, depth)
            raw += _filter(packed, prev, k % 5, bpp)
            prev, k = packed, k + 1
    z = zlib.compress(raw, 6)
    body = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))]
    if palette is not None:
        body.append(_chunk(b"PLTE", palette.astype(np.uint8).tobytes()))
    body += [_chunk(tag, data) for tag, data in extra]
    body += [_chunk(b"IDAT", z[:len(z) // 2]), _chunk(b"IDAT", z[len(z) // 2:]),
             _chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"".join(body))


def _expected_rgb(samples, color, depth, palette=None):
    """What libpng's normalisation gives: RGB8."""
    if color == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette
        return pal[samples[..., 0]]
    top = samples >> 8 if depth == 16 else samples * (255 // (2 ** depth - 1))
    top = top.astype(np.uint8)
    if color in (0, 4):
        return np.repeat(top[..., :1], 3, axis=-1)
    return top[..., :3]


# (name, colour type, bit depth, interlaced)
WRITTEN = [("gray1", 0, 1, False), ("gray2", 0, 2, True), ("gray4", 0, 4, False),
           ("gray8", 0, 8, True), ("gray16", 0, 16, False), ("rgb8", 2, 8, True),
           ("rgb16", 2, 16, True), ("palette1", 3, 1, False), ("palette2", 3, 2, False),
           ("palette4", 3, 4, True), ("palette8", 3, 8, False), ("gray_alpha8", 4, 8, False),
           ("gray_alpha16", 4, 16, True), ("rgba8", 6, 8, False), ("rgba16", 6, 16, True)]


@pytest.mark.parametrize("name,color,depth,interlace", WRITTEN, ids=[c[0] for c in WRITTEN])
def test_every_colour_type_and_depth_decodes_as_libpng(tmp_path, name, color, depth, interlace):
    rng = np.random.default_rng(len(name))
    h, w = 13, 11
    palette = None
    if color == 3:
        n_pal = min(2 ** depth, 200)  # palette8 leaves indices 200..255 to the black default
        palette = rng.integers(0, 256, (n_pal, 3))
        samples = rng.integers(0, min(2 ** depth, 256), (h, w, 1))
    else:
        samples = rng.integers(0, 2 ** depth, (h, w, CHANNELS[color]))
    extra = [(b"tEXt", b"Comment\x00ancillary")]
    if color == 3:
        extra.append((b"tRNS", bytes(range(len(palette)))))
    p = str(tmp_path / f"{name}.png")
    write_png(p, samples, color, depth, palette, interlace, extra)
    got = native.decode_crop_batch([p])[0]
    np.testing.assert_array_equal(got, jnative.decode_crop_batch([p])[0])
    np.testing.assert_array_equal(got, _expected_rgb(samples, color, depth, palette))
    assert native.png_size(p) == jnative.png_size(p) == (h, w)


def _cv2_files(root):
    """Files cv2 writes (libpng's adaptive filters): 8-bit RGB, gray, RGBA,
    16-bit RGB and gray, and a 1-bit bilevel gray."""
    rng = np.random.default_rng(0)
    smooth = (np.add.outer(np.arange(37), 2 * np.arange(53)) % 256).astype(np.uint8)
    imgs = {
        "rgb": np.dstack([smooth, 255 - smooth, rng.integers(0, 256, (37, 53), np.uint8)]),
        "gray": smooth,
        "rgba": rng.integers(0, 256, (37, 53, 4), np.uint8),
        "rgb16": rng.integers(0, 65536, (37, 53, 3), np.uint16),
        "gray16": rng.integers(0, 65536, (37, 53), np.uint16),
    }
    paths = {}
    for k, img in imgs.items():
        paths[k] = str(root / f"{k}.png")
        assert cv2.imwrite(paths[k], img)
    paths["bilevel"] = str(root / "bilevel.png")
    assert cv2.imwrite(paths["bilevel"], (smooth > 128).astype(np.uint8) * 255,
                       [cv2.IMWRITE_PNG_BILEVEL, 1])
    return paths


@pytest.fixture(scope="module")
def cv2_files(tmp_path_factory):
    return _cv2_files(tmp_path_factory.mktemp("cv2"))


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba", "rgb16", "gray16", "bilevel"])
def test_files_cv2_writes_decode_as_libpng(cv2_files, kind):
    p = cv2_files[kind]
    got = native.decode_crop_batch([p], threads=1)
    np.testing.assert_array_equal(got, jnative.decode_crop_batch([p], threads=1))
    assert native.png_size(p) == jnative.png_size(p) == (37, 53)
    if kind == "rgb":  # an 8-bit RGB file: the JAX imread's array too
        np.testing.assert_array_equal(got[0], j_imread(p))


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(1)
    paths = []
    for i in range(5):
        p = str(root / f"{i:04d}.png")
        assert cv2.imwrite(p, rng.integers(0, 256, (24, 30, 3), np.uint8))
        paths.append(p)
    return paths


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_whole_and_cropped_batches_match_the_jax_loader(frames, threads):
    whole = native.decode_crop_batch(frames, threads=threads)
    np.testing.assert_array_equal(whole, jnative.decode_crop_batch(frames, threads=threads))
    for i, p in enumerate(frames):
        np.testing.assert_array_equal(whole[i], j_imread(p))
    y0, x0 = [0, 2, 14, 1, 0], [3, 0, 18, 2, 18]  # the third and fifth end at the border
    crop = native.decode_crop_batch(frames, y0, x0, (10, 12), threads=threads)
    np.testing.assert_array_equal(
        crop, jnative.decode_crop_batch(frames, y0, x0, (10, 12), threads=threads))
    for i in range(len(frames)):
        np.testing.assert_array_equal(crop[i], whole[i, y0[i]:y0[i] + 10, x0[i]:x0[i] + 12])


@pytest.mark.parametrize("shape", [(16, 20, 3), (9, 7)])
def test_encode_is_read_back_by_both_packages(tmp_path, shape):
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / "out.png")
    native.encode_png(p, img)
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    np.testing.assert_array_equal(jnative.decode_crop_batch([p])[0], want)
    np.testing.assert_array_equal(native.decode_crop_batch([p])[0], want)
    np.testing.assert_array_equal(j_imread(p), img)


def test_encoder_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError):
        native.encode_png(str(tmp_path / "a.png"), np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(IOError):
        native.encode_png(str(tmp_path / "missing" / "a.png"), np.zeros((4, 4, 3), np.uint8))


def test_a_larger_later_frame_raises_instead_of_overflowing(frames, tmp_path):
    """Full-frame mode sizes the output from the first frame; the JAX
    loader then writes a larger later frame past the buffer."""
    big = str(tmp_path / "big.png")
    assert cv2.imwrite(big, np.zeros((48, 30, 3), np.uint8))
    with pytest.raises(IOError, match="big.png does not hold the window asked for"):
        native.decode_crop_batch([frames[0], big, frames[1]])


@pytest.mark.parametrize("y0,x0", [(-1, 0), (0, -3), (20, 0), (0, 25)])
def test_a_crop_outside_its_image_raises(frames, y0, x0):
    """A negative offset (which the JAX loader does not check) or a window
    past the far edge."""
    with pytest.raises(IOError, match="does not hold the window"):
        native.decode_crop_batch(frames[:2], [0, y0], [0, x0], (5, 6))


def test_unreadable_and_corrupt_files_raise(frames, tmp_path):
    with pytest.raises(IOError, match="cannot be read"):
        native.decode_crop_batch([str(tmp_path / "none.png")])
    data = bytearray(open(frames[0], "rb").read())
    data[60] ^= 0xFF  # inside the image data: its chunk's CRC no longer holds
    bad = str(tmp_path / "bad.png")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(IOError, match="is not a PNG"):
        native.decode_crop_batch([frames[0], bad])
    with pytest.raises(IOError):
        native.png_size(str(tmp_path / "none.png"))


def test_a_failed_build_raises_with_the_compilers_message(tmp_path):
    src = tmp_path / "broken.cc"
    src.write_text("int pfnl_png_size( { undeclared_name_in_the_codec; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        native.build(source=str(src), lib=str(tmp_path / "lib.so"))
    assert "broken.cc" in str(info.value) and "error" in str(info.value)
    assert not (tmp_path / "lib.so").exists()


def test_build_is_skipped_while_the_library_is_newer(tmp_path):
    lib = str(tmp_path / "lib.so")
    assert native.build(lib=lib) > 0.0
    assert native.build(lib=lib) == 0.0


def _no_cv2_no_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


def test_image_io_takes_the_native_codec_without_cv2_and_pil(monkeypatch, tmp_path, cv2_files):
    assert image_io.codec() == "cv2"
    rgb = np.random.default_rng(3).integers(0, 256, (11, 17, 3), dtype=np.uint8)
    _no_cv2_no_pil(monkeypatch)
    assert image_io.codec() == "native"
    p = str(tmp_path / "a.png")
    image_io.imsave(p, rgb)
    np.testing.assert_array_equal(image_io.imread(p), rgb)
    np.testing.assert_array_equal(image_io.imread(cv2_files["rgb"]), j_imread(cv2_files["rgb"]))
    # gray comes back as RGB, as the JAX native loader gives it (cv2: [H,W])
    gray = image_io.imread(cv2_files["gray"])
    assert gray.shape == (37, 53, 3)
    np.testing.assert_array_equal(gray[..., 0], j_imread(cv2_files["gray"]))
    with pytest.raises(IOError):
        image_io.imsave(str(tmp_path / "missing" / "a.png"), rgb)
    monkeypatch.undo()
    np.testing.assert_array_equal(j_imread(p), rgb)


def test_no_codec_at_all_raises_naming_the_three(monkeypatch, tmp_path, cv2_files):
    src = tmp_path / "broken.cc"
    src.write_text("#error no codec here\n")
    _no_cv2_no_pil(monkeypatch)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "LIB", str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match="no PNG codec among cv2, PIL and the port's native") \
            as info:
        image_io.imread(cv2_files["rgb"])
    assert "cv2: " in str(info.value) and "PIL: " in str(info.value)
    assert "no codec here" in str(info.value)
    with pytest.raises(RuntimeError, match="no PNG codec"):
        image_io.imsave(str(tmp_path / "a.png"), np.zeros((2, 2, 3), np.uint8))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngset")
    filelist, _ = make_dataset(str(root), num_seqs=2, num_frames=10, hw=(48, 48))
    return filelist


@pytest.mark.parametrize("mode", ["single", "double"])
def test_train_pipeline_decodes_pngs_natively_into_the_jax_batches(dataset, monkeypatch, mode):
    """PngFrames windows go through the codec (a read through image_io
    would fail here) and give the JAX pipeline's batches for one seed."""
    def no_read(path):
        raise AssertionError(f"{path} read through image_io, not the native codec")

    monkeypatch.setattr(PngFrames, "read", staticmethod(no_read))
    need_blur = mode != "single"
    batches = []
    for cls, manifest in ((TrainPipeline, load_manifest), (JTrainPipeline, j_load_manifest)):
        pipe = cls(manifest(dataset, 4, need_blur), mode, 3, 8, 4, 2, seed=5, num_threads=1)
        try:
            batches.append([pipe.get_batch() for _ in range(2)])
        finally:
            pipe.close()
    for got, want in zip(*batches):
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
