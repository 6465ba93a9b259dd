"""The parity rehearsal of the port (pfnl_tpu_torch/parity_rehearsal.py)
and its TF1 checkpoint writer (utils/tf1_ckpt.save_tf1_checkpoint) against
the JAX script (scripts/parity_rehearsal.py) and package on the CPU, then
`python -m pfnl_tpu_torch.parity_rehearsal --small --device cpu` end to end.

TensorFlow's own reader checks the writer where TensorFlow imports, in a
subprocess (TF, JAX and torch in one process eventually crash), skipped
where it is missing, as tests/test_torch_tf1_import.py does."""

import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.utils import tf1_ckpt as jckpt
from pfnl_tpu.utils import tf1_imports as jimports
from pfnl_tpu.utils.image_io import imread, imsave

from pfnl_tpu_torch.__main__ import main as cli
from pfnl_tpu_torch.parity_rehearsal import (VID4, VID4_SMALL, render_dataset, synth_tf1_ckpt,
                                             truth_matches)
from pfnl_tpu_torch.utils import tf1_ckpt
from pfnl_tpu_torch.utils.weights import from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jrehearsal = _script("parity_rehearsal")


def test_the_geometries_are_the_scripts():
    assert VID4 == jrehearsal.VID4 and VID4_SMALL == jrehearsal.VID4_SMALL


def test_render_dataset_matches_the_script(tmp_path):
    seqs = VID4_SMALL[:1]
    render_dataset(str(tmp_path / "torch"), seqs)
    jrehearsal.render_dataset(str(tmp_path / "jax"), seqs)
    name, nf, h, w = seqs[0]
    for t in range(nf):
        got, want = (imread(str(tmp_path / r / name / "truth" / f"{t:04d}.png"))
                     for r in ("torch", "jax"))
        assert got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """render_dataset's truth/ of calendar at 6 frames, 24x32."""
    root = str(tmp_path_factory.mktemp("vid4"))
    render_dataset(root, [("calendar", 6, 24, 32)])
    return root


@pytest.mark.parametrize("seqs, want", [
    ([("calendar", 6, 24, 32)], True),
    ([("calendar", 5, 24, 32)], False),
    ([("calendar", 6, 24, 40)], False),
    ([("calendar", 6, 24, 32), ("city", 6, 24, 32)], False),
    ([("city", 6, 24, 32)], False),
])
def test_truth_matches_only_the_geometry_rendered(rendered, seqs, want):
    """Stage 1 is skipped only where --root holds exactly these sequences,
    each at its frame count and size."""
    assert truth_matches(rendered, seqs) is want


@pytest.mark.parametrize("data,want", [(b"123456789", 0xE3069283), (bytes(32), 0x8A9136AA),
                                       (b"", 0)])
def test_crc32c_known_values(data, want):
    assert tf1_ckpt.crc32c(data) == want


def _arrays():
    rng = np.random.default_rng(3)
    return {"nlvsr/conv0/kernel": rng.standard_normal((5, 5, 3, 64)).astype(np.float32),
            "global_step": np.asarray(150000, np.int64),
            "a/scalar_f64": np.asarray(2.5),
            "ints": np.arange(7, dtype=np.int32),
            "half": rng.standard_normal((3, 2)).astype(np.float16),
            "empty": np.zeros((0, 4), np.float32),
            # enough bytes for several data blocks, names for prefix sharing
            "big/w": rng.standard_normal((300, 300)).astype(np.float32),
            **{f"many/v{i:03d}": rng.standard_normal((17,)).astype(np.float32)
               for i in range(40)}}


def test_save_tf1_checkpoint_round_trip(tmp_path):
    """Both readers, the port's and the JAX package's, give back every
    array bitwise, with its dtype and shape."""
    arrays = _arrays()
    prefix = str(tmp_path / "ck" / "model.ckpt")
    tf1_ckpt.save_tf1_checkpoint(prefix, arrays)
    assert sorted(os.listdir(tmp_path / "ck")) == ["model.ckpt.data-00000-of-00001",
                                                   "model.ckpt.index"]
    for reader in (tf1_ckpt.load_tf1_checkpoint, jckpt.load_tf1_checkpoint):
        back = reader(prefix)
        assert set(back) == set(arrays)
        for k, v in arrays.items():
            assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
            np.testing.assert_array_equal(back[k], v)
    listed = jckpt.list_tf1_variables(prefix)
    assert listed == tf1_ckpt.list_tf1_variables(prefix)
    assert listed["big/w"] == ([300, 300], 1) and listed["global_step"] == ([], 9)


_TF_READ = """
import sys
import numpy as np
import tensorflow as tf

prefix, npz = sys.argv[1:3]
want = np.load(npz)
reader = tf.train.load_checkpoint(prefix)
assert set(reader.get_variable_to_shape_map()) == set(want.files)
for k in want.files:
    got = reader.get_tensor(k)
    assert got.dtype == want[k].dtype and np.array_equal(got, want[k]), k
try:  # TF checks each tensor's crc32c: a flipped byte must fail
    with open(prefix + ".data-00000-of-00001", "r+b") as f:
        f.seek(3)
        b = f.read(1)
        f.seek(3)
        f.write(bytes([b[0] ^ 1]))
    tf.train.load_checkpoint(prefix).get_tensor(sorted(want.files)[0])
    print("CRC NOT CHECKED")
except Exception as e:
    print("CRC CHECKED", type(e).__name__)
print("TF READ OK", len(want.files))
"""


def test_tensorflow_reads_the_written_checkpoint(tmp_path):
    arrays = _arrays()
    prefix = str(tmp_path / "model.ckpt")
    tf1_ckpt.save_tf1_checkpoint(prefix, arrays)
    np.savez(str(tmp_path / "want.npz"), **arrays)
    proc = subprocess.run([sys.executable, "-c", _TF_READ, prefix, str(tmp_path / "want.npz")],
                          capture_output=True, text=True, timeout=600)
    if "No module named 'tensorflow'" in proc.stderr:
        pytest.skip("tensorflow unavailable")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"TF READ OK {len(arrays)}" in proc.stdout
    assert "CRC CHECKED" in proc.stdout, proc.stdout


def test_synth_tf1_ckpt_is_the_scripts_and_imports(tmp_path, monkeypatch):
    """The script's arrays (what it hands its TensorFlow subprocess, as an
    npz) equal the port's, which the checkpoint holds; `import-tf1 pfnl`
    of that checkpoint loads the JAX importer's parameters bitwise."""
    monkeypatch.setattr(jrehearsal.subprocess, "run", lambda *a, **k: None)
    jprefix = str(tmp_path / "jax" / "pfnl.ckpt")
    os.makedirs(os.path.dirname(jprefix))
    jrehearsal.synth_tf1_ckpt(jprefix)
    want = dict(np.load(jprefix + ".vars.npz"))
    monkeypatch.undo()
    prefix = str(tmp_path / "torch" / "pfnl.ckpt")
    got = synth_tf1_ckpt(prefix)
    assert list(got) == list(want)
    back = tf1_ckpt.load_tf1_checkpoint(prefix)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
        np.testing.assert_array_equal(back[k], v)
    save_dir = str(tmp_path / "imported")
    cli(["import-tf1", "pfnl", "--ckpt", prefix, "--save-dir", save_dir])
    state = torch.load(os.path.join(save_dir, "ckpt_000000000.pt"), weights_only=True)
    ref = from_flax(jimports.import_pfnl_tf1(want))
    assert set(state["model"]) == set(ref)
    for k, v in ref.items():
        assert torch.equal(state["model"][k], v), k


def test_rehearsal_small_on_the_cpu_end_to_end(tmp_path):
    """`python -m pfnl_tpu_torch.parity_rehearsal --small --device cpu`:
    the five stages timed, a finite table of the four sequences and their
    average, written to --out.  --root and --ckdir default to $TMPDIR; a
    sequence left there by another run is cleared before the render."""
    out = tmp_path / "REHEARSAL.md"
    data = tmp_path / "vid4_shaped_torch"
    (data / "stale" / "truth").mkdir(parents=True)
    imsave(str(data / "stale" / "truth" / "0000.png"), np.zeros((8, 8, 3), np.uint8))
    env = dict(os.environ, OMP_NUM_THREADS="2", TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "pfnl_tpu_torch.parity_rehearsal", "--small", "--device", "cpu",
         "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    stages = re.findall(r"^\[rehearsal\] (\d) .*: ([\d.]+)s$", proc.stdout, re.M)
    assert [s for s, _ in stages] == ["1", "2", "3", "4", "5"]
    text = out.read_text()
    assert "on CPU" in text and text.count("s |\n") == 5
    rows = re.findall(r"^\| (\w+) \| (\d+) \| ([-\d.]+) \| ([-\d.]+) \|$", text, re.M)
    assert [r[0] for r in rows] == ["calendar", "city", "foliage", "walk", "average"]
    assert [int(r[1]) for r in rows] == [18] * 4 + [72]
    assert all(np.isfinite(float(r[2])) and np.isfinite(float(r[3])) for r in rows)
    assert sorted(os.listdir(data)) == sorted(name for name, _, _, _ in VID4_SMALL)
    assert os.listdir(tmp_path / "parity_ck_torch" / "tf1")
    for name, _, h, w in VID4_SMALL:
        frames = sorted(os.listdir(data / name / "rehearsal"))
        assert len(frames) == 18
        assert imread(str(data / name / "rehearsal" / frames[0])).shape == (h, w, 3)
