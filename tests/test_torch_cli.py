"""The port's command line round trip on the CPU, as JAX `run.py` does it:
`train pfnl` writes checkpoints under --save-dir, `test` with the same
--save-dir and no --weights serves the newest of them, and `eval` evaluates
it at its step."""

import glob
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.utils.image_io import imread

from pfnl_tpu_torch.__main__ import main
from pfnl_tpu_torch.config import preset
from pfnl_tpu_torch.infer.predictor import Predictor
from pfnl_tpu_torch.models.pfnl import PFNL
from tests.util_data import make_dataset


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A synthetic set (4 sequences of 20 frames: the evaluator batches 4
    windows) and a --save-dir holding the checkpoint of 2 training steps."""
    root = tmp_path_factory.mktemp("clidata")
    filelist, seq_dirs = make_dataset(str(root), num_seqs=4, num_frames=20, hw=(48, 48))
    save_dir = str(tmp_path_factory.mktemp("clickpt"))
    main(["train", "pfnl", "--train-list", filelist, "--steps", "3", "--in-size", "8",
          "--batch-size", "2", "--save-dir", save_dir, "--save-every", "2", "--no-eval",
          "--device", "cpu"])
    assert [os.path.basename(p) for p in glob.glob(os.path.join(save_dir, "ckpt_*.pt"))] == [
        "ckpt_000000002.pt"]
    return str(root), filelist, seq_dirs, save_dir


def _pngs(seq, name):
    return [imread(p) for p in sorted(glob.glob(os.path.join(seq, name, "*.png")))]


def test_test_serves_the_newest_checkpoint_of_save_dir(trained, tmp_path):
    root, _, seq_dirs, save_dir = trained
    seq = seq_dirs[-1]
    main(["test", "pfnl", "--data", root, "--start", "3", "--save-dir", save_dir,
          "--device", "cpu", "--name", "sr_ckpt"])
    main(["test", "pfnl", "--data", root, "--start", "3", "--save-dir", str(tmp_path),
          "--device", "cpu", "--name", "sr_seed"])
    # the trained weights, served through the Predictor directly
    cfg = preset("pfnl")
    model = PFNL(num_frames=cfg.num_frames, scale=cfg.scale)
    state = torch.load(os.path.join(save_dir, "ckpt_000000002.pt"), weights_only=True)
    model.load_state_dict(state["model"])
    Predictor(model.eval()).test_video_truth(seq, name="sr_want")
    got, seed, want = (_pngs(seq, n) for n in ("sr_ckpt", "sr_seed", "sr_want"))
    assert len(got) == len(want) == len(seed) == 20
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert not all(np.array_equal(a, b) for a, b in zip(got, seed))  # not the seed's weights


def test_eval_logs_the_restored_step(trained):
    _, filelist, _, save_dir = trained
    main(["eval", "pfnl", "--save-dir", save_dir, "--eval-list", filelist, "--device", "cpu"])
    with open(os.path.join(save_dir, "pfnl.txt")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1 and lines[0].startswith('{"Iter": 2 , "PSNR": [')
