"""Quality out: the port's metrics (eval/metrics.py), parity tables
(eval/tables.py) and dataset preparation (data/prepare.py) against the JAX
package's on the CPU, and `python -m pfnl_tpu_torch prepare` / `parity`
end to end on a small dataset."""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.data.prepare import make_filelists as jmake_filelists, render_blur as jrender_blur
from pfnl_tpu.eval import metrics as jmetrics
from pfnl_tpu.eval.tables import dataset_table as jdataset_table
from pfnl_tpu.ops.color import rgb2ycbcr_np as jrgb2ycbcr_np
from pfnl_tpu.utils.image_io import imread, imsave

from pfnl_tpu_torch.__main__ import main
from pfnl_tpu_torch.data.frames import MemoryFrames, PngFrames
from pfnl_tpu_torch.data.prepare import make_filelists, render_blur
from pfnl_tpu_torch.eval import metrics
from pfnl_tpu_torch.eval.tables import dataset_table
from pfnl_tpu_torch.ops.color import rgb2ycbcr_np
from tests.util_data import make_dataset


def _images(seed, shape=(24, 30, 3)):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, shape), 0, 255).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("name", ["psnr_y_matlab", "ssim_y_matlab"])
@pytest.mark.parametrize("seed", [0, 1])
def test_metric_matches_jax(name, seed):
    a, b = _images(seed)
    got, want = getattr(metrics, name)(a, b), getattr(jmetrics, name)(a, b)
    assert abs(got - want) <= 1e-12 * abs(want)


def test_ssim_psnr_and_ycbcr_match_jax():
    a, b = _images(2, (17, 19))
    y1, y2 = a.astype(np.float64), b.astype(np.float64)
    assert abs(metrics.compute_ssim(y1, y2) - jmetrics.compute_ssim(y1, y2)) <= 1e-12
    mse = np.array([1e-3, 4e-4])
    np.testing.assert_allclose(metrics.psnr_from_mse(mse), jmetrics.psnr_from_mse(mse), rtol=1e-12)
    img = np.random.default_rng(3).integers(0, 256, (5, 6, 3)).astype(np.float64)
    for max_val in (255.0, 1):
        np.testing.assert_allclose(rgb2ycbcr_np(img, max_val), jrgb2ycbcr_np(img, max_val),
                                   rtol=1e-12)
    assert metrics.psnr_y_matlab(a, a) == float("inf")


@pytest.fixture
def dataset(tmp_path):
    """Two sequences of 3 frames, HR 24x32, and a `res/` of noisy truths."""
    root = str(tmp_path / "ds")
    make_dataset(root, num_seqs=2, num_frames=3, hw=(24, 32))
    rng = np.random.default_rng(0)
    for seq in sorted(glob.glob(os.path.join(root, "seq_*"))):
        os.makedirs(os.path.join(seq, "res"))
        for p in sorted(glob.glob(os.path.join(seq, "truth", "*.png"))):
            noisy = np.clip(imread(p).astype(int) + rng.integers(-3, 4, (24, 32, 3)), 0, 255)
            imsave(os.path.join(seq, "res", os.path.basename(p)), noisy.astype(np.uint8))
    return root


def test_dataset_table_matches_jax(dataset):
    lines, jlines = [], []
    got = dataset_table(dataset, "res", print_fn=lines.append)
    want = jdataset_table(dataset, "res", print_fn=jlines.append)
    assert lines == jlines and list(got) == list(want) == ["seq_000", "seq_001", "average"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)


def test_dataset_table_reads_a_memory_store(dataset):
    """The same table from the frames held in MemoryFrames, as on a
    machine without a PNG codec."""
    png = PngFrames()
    mem = MemoryFrames({p: png.read(p) for p in glob.glob(os.path.join(dataset, "*", "*", "*.png"))})
    assert mem.sequences(dataset) == png.sequences(dataset)
    lines, mlines = [], []
    assert dataset_table(dataset, "res", lines.append, source=mem) == dataset_table(
        dataset, "res", mlines.append)
    assert lines == mlines
    with pytest.raises(FileNotFoundError):
        dataset_table(dataset, "missing", print_fn=lambda *a: None, source=mem)


def test_render_blur_matches_jax(tmp_path):
    """blur4/ rendered by the port on the device (here the CPU) and by JAX:
    the same files, bytes within 1 level."""
    root = str(tmp_path / "ds")
    _, seqs = make_dataset(root, num_seqs=1, num_frames=5, hw=(40, 52))
    shutil.rmtree(os.path.join(seqs[0], "blur4"))
    shutil.copytree(seqs[0], seqs[0] + "_jax")
    assert render_blur(seqs[0], batch=2, device="cpu") == 5
    assert jrender_blur(seqs[0] + "_jax", batch=2) == 5
    got = sorted(glob.glob(os.path.join(seqs[0], "blur4", "*.png")))
    want = sorted(glob.glob(os.path.join(seqs[0] + "_jax", "blur4", "*.png")))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        ia, ib = imread(a).astype(int), imread(b).astype(int)
        assert ia.shape == (10, 13, 3) and np.abs(ia - ib).max() <= 1, a
    assert render_blur(seqs[0], device="cpu") == 0  # no overwrite by default


def test_make_filelists_matches_jax(tmp_path):
    root = str(tmp_path / "ds")
    make_dataset(root, num_seqs=4, num_frames=2, hw=(8, 8))
    quiet = dict(print_fn=lambda *a: None)
    ours = make_filelists(root, val_count=1, out_train=str(tmp_path / "t"),
                          out_val=str(tmp_path / "v"), **quiet)
    theirs = jmake_filelists(root, val_count=1, out_train=str(tmp_path / "jt"),
                             out_val=str(tmp_path / "jv"), **quiet)
    for a, b in zip(ours, theirs):
        assert open(a).read() == open(b).read()


def test_cli_prepare_then_parity(tmp_path, capsys):
    """prepare renders blur4/ and the filelists; parity frvsr serves every
    sequence into <seq>/frvsr_parity/ and prints the JAX table of those
    frames; --tables-only prints it again without serving."""
    root = str(tmp_path / "ds")
    _, seqs = make_dataset(root, num_seqs=2, num_frames=3, hw=(32, 40))
    for s in seqs:
        shutil.rmtree(os.path.join(s, "blur4"))
    main(["prepare", "--root", root, "--val-count", "1", "--device", "cpu"])
    assert len(glob.glob(os.path.join(root, "seq_*", "blur4", "*.png"))) == 6
    assert open(os.path.join(root, "filelist_val.txt")).read().split() == [seqs[-1]]
    capsys.readouterr()

    main(["parity", "frvsr", "--data", root, "--device", "cpu", "--save-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert len(glob.glob(os.path.join(root, "seq_*", "frvsr_parity", "*.png"))) == 6
    jlines = []
    jdataset_table(root, "frvsr_parity", print_fn=jlines.append)
    assert out.splitlines()[-len(jlines):] == jlines
    for s in seqs:
        shutil.rmtree(os.path.join(s, "blur4"))  # --tables-only reads no LR frame
    main(["parity", "frvsr", "--data", root, "--tables-only"])
    assert capsys.readouterr().out.splitlines() == jlines
