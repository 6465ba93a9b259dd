"""Weights in: the port's TF1 reader and the seven family importers
(pfnl_tpu_torch/utils/tf1_ckpt.py, tf1_imports.py) against the JAX
package's, and `python -m pfnl_tpu_torch import-tf1` on the CPU.

Each importer is given the same dict of seeded arrays, named as the
reference's TF1 graphs name them, at the port's default widths; the port's
parameters must equal the JAX importer's bitwise after `from_flax` and
load into the family's model with strict=True.  The reader and the CLI
are held on a checkpoint written by TensorFlow in a subprocess
(tests/tf_write_ckpt.py), skipped where TensorFlow is missing, as
tests/test_tf1_import.py does; the DUF hdf5 path is skipped without h5py."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.config import preset as jpreset
from pfnl_tpu.infer.predictor import Predictor as JPredictor
from pfnl_tpu.models.frvsr import FRVSR as JFRVSR
from pfnl_tpu.utils import tf1_ckpt as jckpt
from pfnl_tpu.utils import tf1_imports as jimports
from pfnl_tpu.utils.image_io import imread

from pfnl_tpu_torch.__main__ import main
from pfnl_tpu_torch.config import preset
from pfnl_tpu_torch.models import MODEL_REGISTRY
from pfnl_tpu_torch.train.trainer import Trainer, save_checkpoint
from pfnl_tpu_torch.utils import tf1_ckpt, tf1_imports
from pfnl_tpu_torch.utils.weights import from_flax, to_flax
from tests.util_data import make_dataset

_HELPER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tf_write_ckpt.py")
EASYFLOW = (("c1", 5, 2, 24), ("c2", 3, 24, 24), ("c3", 5, 24, 24), ("c4", 3, 24, 24),
            ("c5", 3, 24, 32), ("s1", 5, 5, 24), ("s2", 3, 24, 24), ("s3", 3, 24, 24),
            ("s4", 3, 24, 24), ("s5", 3, 24, 8))


def tf_vars(family, seed=0, scale=0.1):
    """{TF1 variable name: seeded float32 array} of the family at the port's
    default widths, named as the reference's graphs name them
    (pfnl_tpu/utils/tf1_imports.py), plus an optimizer slot and the global
    step, which the importers must skip."""
    rng = np.random.default_rng(seed)
    v = {"global_step": np.asarray(1234, np.int64)}

    def w(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def conv(scope, k, ci, co, kind="layers", alpha=False):
        kn, bn = ("weights", "biases") if kind == "slim" else ("kernel", "bias")
        v[f"{scope}/{kn}"], v[f"{scope}/{bn}"] = w(k, k, ci, co), w(co)
        if alpha:
            v[f"{scope}/alpha"] = w(co)

    def easyflow():
        for name, k, ci, co in EASYFLOW:
            conv(f"easyflow/{name}", k, ci, co, "slim")

    if family == "pfnl":
        t, mf, c = 7, 64, 84
        for m in ("g", "w"):
            conv(f"nlvsr/nlblock_0/{m}/{m}", 1, c, c)
        conv("nlvsr/conv0", 5, 3, mf)
        for i in range(20):
            conv(f"nlvsr/conv1_{i}", 3, mf, mf)
            v[f"nlvsr/conv10_{i}/kernel"], v[f"nlvsr/conv10_{i}/bias"] = w(1, 1, t * mf, mf), w(mf)
            conv(f"nlvsr/conv2_{i}", 3, 2 * mf, mf)
        conv("nlvsr/convmerge1", 3, t * mf, 48)
        conv("nlvsr/convmerge2", 3, 12, 12)
        v["nlvsr/conv0/kernel/Adam"] = w(5, 5, 3, mf)
    elif family == "vespcn":
        easyflow()
        conv("srmodel/enc1", 5, 3, 24, "slim", True)
        for i in range(9):
            conv(f"srmodel/enc2_{i}", 3, 24, 24, "slim", True)
        conv("srmodel/conv6", 3, 24, 16, "slim", True)
        conv("srmodel/rnn_out", 3, 4, 4, "slim")
    elif family == "mcresnet":
        easyflow()
        for d in range(3):
            conv(f"srmodel/enc1_{d}", 5, 1, 64, "slim", True)
        for i in range(9):
            conv(f"srmodel/enc2_{i}", 3, 320 if i == 0 else 32, 32, "slim", True)
        conv("srmodel/conv6", 3, 32, 16, "slim", True)
        conv("srmodel/rnn_out", 3, 4, 4, "slim")
    elif family == "ltdvsr":
        for j, (k, ci, co) in enumerate(((9, 2, 32), (9, 32, 32), (3, 32, 2))):
            conv(f"flow/conv{j}", k, ci, co)
        for b in range(3):
            for j, (k, ci, co) in ((0, (5, 2 * b + 1, 64)), (1, (3, 64, 64)), (3, (3, 64, 64)),
                                   (2, (3, 64, 16))):
                conv(f"ltdvsr/conv{b}_{j}", k, ci, co)
        for j, (ci, co) in enumerate(((5, 32), (32, 16), (16, 3))):
            conv(f"ltdvsr/tem{j}", 5, ci, co)
    elif family == "drvsr":
        easyflow()
        for name, k, ci, co in (("enc1", 5, 1, 32), ("enc2", 3, 32, 64), ("enc2_1", 3, 64, 64),
                                ("enc3", 3, 64, 128), ("enc3_1", 3, 128, 128),
                                ("dec1_1", 3, 64, 64), ("dec2_1", 3, 32, 32), ("dec3", 5, 32, 1),
                                ("dec1", 4, 64, 128), ("dec2", 4, 32, 64)):  # TF [kh,kw,out,in]
            conv(f"srmodel/{name}", k, ci, co, "slim")
        for name, co in (("dec1", 64), ("dec2", 32)):  # a transposed conv's bias is [out]
            v[f"srmodel/{name}/biases"] = w(co)
        conv("srmodel/convLSTM/LSTM_conv", 3, 256, 512, "slim")
    elif family == "frvsr":
        cin = 6
        for p in range(3):
            for q in range(2):
                conv(f"flow/conv0_{p}_{q}", 3, cin, 32 * 2 ** p)
                cin = 32 * 2 ** p
        for p in range(3):
            for q in range(2):
                conv(f"flow/conv1_{p}_{q}", 3, cin, 256 // 2 ** p)
                cin = 256 // 2 ** p
        conv("flow/conv2", 3, 64, 32)
        conv("flow/conv3", 3, 32, 2)
        conv("frvsr/conv0_0", 3, 3, 128)
        conv("frvsr/conv0_1", 3, 51, 128)
        for j in range(10):
            conv(f"frvsr/conv1_{j}", 3, 128, 128)
            conv(f"frvsr/conv2_{j}", 3, 128, 128)
        for name, co in (("large1", 128), ("large2", 128), ("out", 3)):
            conv(f"frvsr/{name}", 3, 128, co)
    elif family == "duf":
        def bn(name, ch):
            v[f"G/{name}/beta"], v[f"G/{name}/gamma"] = w(ch), 1 + w(ch)
            v[f"G/{name}/moving_mean"], v[f"G/{name}/moving_variance"] = w(ch), 0.5 + np.abs(w(ch))

        v["G/conv1/W"], v["G/conv1/b"] = w(1, 3, 3, 3, 64), w(64)
        f = 64
        for r in range(1, 25):
            bn(f"Rbn{r}a", f)
            v[f"G/Rconv{r}a/W"], v[f"G/Rconv{r}a/b"] = w(1, 1, 1, f, f), w(f)
            bn(f"Rbn{r}b", f)
            v[f"G/Rconv{r}b/W"], v[f"G/Rconv{r}b/b"] = w(3, 3, 3, f, 16), w(16)
            f += 16
        bn("fbn1", f)
        for name, shape in (("conv2", (1, 3, 3, f, 256)), ("rconv1", (1, 1, 1, 256, 256)),
                            ("rconv2", (1, 1, 1, 256, 48)), ("fconv1", (1, 1, 1, 256, 512)),
                            ("fconv2", (1, 1, 1, 512, 400))):
            v[f"G/{name}/W"], v[f"G/{name}/b"] = w(*shape), w(shape[-1])
        # an identity constant of the reference graph (utils.py:339-340), not a weight
        v["G/DynFilter3D/filter_localexpand"] = np.eye(25, dtype=np.float32).reshape(1, 5, 5, 1, 25)
    return v


def _state(imported, has_stats):
    params, stats = imported if has_stats else (imported, None)
    return from_flax(params, stats)


@pytest.mark.parametrize("family", sorted(tf1_imports.IMPORTERS))
def test_importer_matches_jax_and_fits_the_model(family):
    v = tf_vars(family)
    importer, keys, has_stats = tf1_imports.IMPORTERS[family]
    jimporter, jkeys, jhas_stats = jimports.IMPORTERS[family]
    assert (keys, has_stats) == (jkeys, jhas_stats)
    kw = {k: getattr(preset(family), k) for k in keys}
    got, want = _state(importer(v, **kw), has_stats), _state(jimporter(v, **kw), has_stats)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    MODEL_REGISTRY[family]().load_state_dict(got, strict=True)


def test_importer_names_a_missing_variable():
    v = tf_vars("frvsr")
    del v["frvsr/large2/kernel"]
    with pytest.raises(KeyError, match="frvsr/large2/kernel"):
        tf1_imports.import_frvsr_tf1(v)


def test_import_tf1_names_what_does_not_fit(tmp_path, monkeypatch):
    """A tree whose shapes are not the model's fails with the parameter's name."""
    bad = tf1_imports.import_ltdvsr_tf1(tf_vars("ltdvsr"))
    bad["tem2"]["kernel"] = bad["tem2"]["kernel"][:, :, :8]
    monkeypatch.setitem(tf1_imports.IMPORTERS, "ltdvsr", (lambda prefix, num_frames: bad,
                                                          ("num_frames",), False))
    with pytest.raises(SystemExit, match="tem2.kernel"):
        main(["import-tf1", "ltdvsr", "--ckpt", "unused", "--save-dir", str(tmp_path)])
    assert not glob.glob(os.path.join(str(tmp_path), "ckpt_*.pt"))


def test_trainer_resumes_a_checkpoint_without_optimizer_state(tmp_path):
    """What import-tf1 writes (step 0, the model alone) restores, and Adam
    starts fresh."""
    cfg = preset("pfnl", save_dir=str(tmp_path))
    model = MODEL_REGISTRY["pfnl"](generator=torch.Generator().manual_seed(5))
    save_checkpoint(cfg.save_dir, {"step": 0, "model": model.state_dict()})
    tr = Trainer(cfg, device="cpu")
    assert tr.restore() and tr.global_step == 0
    assert not tr.optimizer.state_dict()["state"]
    for (k, a), b in zip(tr.model.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------- DUF's hdf5 weights

def _h5(path, tree):
    """The reference's LoadParams layout: a `params` group of datasets whose
    names mangle to the flax paths ('_' -> '__', then '/' -> '_'), plus one
    that matches nothing."""
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("params")
        for name, arr in tree:
            g.create_dataset(name.replace("_", "__").replace("/", "_"), data=arr)
        g.create_dataset("G_missing_x", data=np.zeros(3))


def test_duf_hdf5_matches_jax_and_import_tf1_writes_it(tmp_path):
    pytest.importorskip("h5py")
    rng = np.random.default_rng(3)
    model = MODEL_REGISTRY["duf"](generator=torch.Generator().manual_seed(0))
    params, stats = to_flax(model)
    new = [("G/conv1/W", rng.standard_normal((1, 3, 3, 3, 64)).astype(np.float32)),
           ("G/fbn1/gamma", rng.standard_normal(448).astype(np.float32)),
           ("G/fbn1/moving_variance", rng.random(448).astype(np.float32) + 0.5)]
    path = str(tmp_path / "duf.h5")
    _h5(path, new)
    got = from_flax(*tf1_imports.import_duf_hdf5(params, stats, path, verbose=False))
    jp, js = jimports.import_duf_hdf5(params, stats, path, verbose=False)
    want = from_flax(jp, js)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_array_equal(got["G.conv1.W"].numpy(), new[0][1])
    np.testing.assert_array_equal(got["G.fbn1.biased_var"].numpy(), new[2][1])

    main(["import-tf1", "duf", "--ckpt", path, "--save-dir", str(tmp_path / "ck")])
    state = torch.load(str(tmp_path / "ck" / "ckpt_000000000.pt"), weights_only=True)
    assert state["step"] == 0 and "optimizer" not in state
    for k in want:
        assert torch.equal(state["model"][k], want[k]), k


def test_hdf5_without_h5py_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    model = MODEL_REGISTRY["duf"](layers=16)
    with pytest.raises(ImportError, match="h5py"):
        tf1_imports.import_duf_hdf5(*to_flax(model), str(tmp_path / "w.h5"))


# ---------------------------------------------------------------- a TF-written checkpoint

@pytest.fixture(scope="module")
def tf_ckpt(tmp_path_factory):
    """One checkpoint written by TensorFlow holding the PFNL and FRVSR
    variables (their names do not collide) and arrays for the reader."""
    rng = np.random.default_rng(9)
    arrays = {**tf_vars("pfnl", 1), **tf_vars("frvsr", 2, scale=0.02),
              "deep/nested/name/v": rng.standard_normal((5, 7)).astype(np.float32),
              # enough variables for several index blocks
              **{f"many/v{i:03d}": rng.standard_normal((17,)).astype(np.float32)
                 for i in range(80)}}
    prefix = str(tmp_path_factory.mktemp("tf1") / "model.ckpt")
    np.savez(prefix + ".vars.npz", **arrays)
    proc = subprocess.run([sys.executable, _HELPER, prefix + ".vars.npz", prefix],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        if "No module named" in proc.stderr:
            pytest.skip("tensorflow unavailable")
        raise RuntimeError(f"tf_write_ckpt failed:\n{proc.stderr[-3000:]}")
    return prefix, arrays


def test_reader_round_trip(tf_ckpt):
    prefix, arrays = tf_ckpt
    names = tf1_ckpt.list_tf1_variables(prefix)
    assert names == jckpt.list_tf1_variables(prefix) and set(names) == set(arrays)
    assert names["frvsr/large1/kernel"][0] == [3, 3, 128, 128]
    loaded = tf1_ckpt.load_tf1_checkpoint(prefix)
    for name, want in arrays.items():
        np.testing.assert_array_equal(loaded[name], want)


def test_import_tf1_pfnl_then_train_resumes_at_step_0(tf_ckpt, tmp_path):
    prefix, arrays = tf_ckpt
    main(["import-tf1", "pfnl", "--ckpt", prefix, "--save-dir", str(tmp_path)])
    tr = Trainer(preset("pfnl", save_dir=str(tmp_path)), device="cpu")
    assert tr.restore() and tr.global_step == 0
    want = from_flax(jimports.import_pfnl_tf1(arrays))
    for k, a in tr.model.state_dict().items():
        assert torch.equal(a, want[k]), k


def test_import_tf1_then_test_serves_the_jax_sr(tf_ckpt, tmp_path):
    """import-tf1 frvsr, then `test` on the CPU from that checkpoint, against
    the JAX Predictor with the JAX importer's parameters: within one level."""
    prefix, arrays = tf_ckpt
    root = tmp_path / "data"
    _, seq_dirs = make_dataset(str(root), num_seqs=1, num_frames=4, hw=(32, 40))
    save_dir = str(tmp_path / "ck")
    main(["import-tf1", "frvsr", "--ckpt", prefix, "--save-dir", save_dir])
    main(["test", "frvsr", "--data", str(root), "--save-dir", save_dir, "--device", "cpu",
          "--name", "torch"])
    params = jimports.import_frvsr_tf1(arrays)
    JPredictor(jpreset("frvsr"), JFRVSR(), {"params": params}).test_video_lr(seq_dirs[0],
                                                                             name="jax")
    got, want = ([imread(p) for p in sorted(glob.glob(os.path.join(seq_dirs[0], n, "*.png")))]
                 for n in ("torch", "jax"))
    assert len(got) == len(want) == 4 and got[0].shape == (32, 40, 3)
    diff = np.abs(np.stack(got).astype(int) - np.stack(want).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    assert np.stack(want).std() > 0  # the SR is not a constant frame


def test_import_tf1_refuses_hdf5_for_another_family(tmp_path):
    with pytest.raises(SystemExit, match="only defined for duf"):
        main(["import-tf1", "frvsr", "--ckpt", str(tmp_path / "w.h5"),
              "--save-dir", str(tmp_path)])
