"""The port's training input pipeline against the JAX package's, on the
CPU: manifests, the host sampler (identical uint8 batches from one seed,
in all three producer modes), the alignment-corrected flip crop, and the
device-side augmentation + degradation fed the same flips (a jax.random
key and a torch.Generator cannot draw the same bits)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.data.manifest import load_manifest as j_load_manifest
from pfnl_tpu.data.pipeline import TrainPipeline as JTrainPipeline
from pfnl_tpu.data.pipeline import device_augment_and_degrade as j_device_augment_and_degrade
from pfnl_tpu.data.pipeline import _flip_clip as j_flip_clip
from pfnl_tpu.data.pipeline import sample_flip_crop as j_sample_flip_crop
from pfnl_tpu.ops.degrade import downsample as j_downsample
from pfnl_tpu.utils.image_io import imread

from pfnl_tpu_torch.data.frames import MemoryFrames
from pfnl_tpu_torch.data.manifest import load_manifest
from pfnl_tpu_torch.data.pipeline import (TrainPipeline, device_augment_and_degrade,
                                          sample_flip_crop)
from tests.util_data import make_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torchtrain")
    filelist, _ = make_dataset(str(root), num_seqs=2, num_frames=10, hw=(48, 48))
    return filelist


def test_load_manifest_matches_jax(dataset):
    for need_blur in (False, True):
        got, want = load_manifest(dataset, 4, need_blur), j_load_manifest(dataset, 4, need_blur)
        assert [(s.path, s.truth, s.blur, s.name) for s in got] == \
            [(s.path, s.truth, s.blur, s.name) for s in want]
        assert len(got) == 2 and len(got[0].truth) == len(got[0].blur) == 10


def test_sample_flip_crop_matches_jax():
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    for h, w in [(12, 12), (8, 12), (12, 9)] * 20:
        assert sample_flip_crop(a, h, w, 8, 4) == j_sample_flip_crop(b, h, w, 8, 4)


def _batches(cls, seqs, mode, n, **kw):
    pipe = cls(seqs, mode, num_frames=3, in_size=8, scale=4, batch_size=2, seed=7,
               num_threads=1, prefetch=2, **kw)
    try:
        return [pipe.get_batch() for _ in range(n)]
    finally:
        pipe.close()


@pytest.mark.parametrize("mode", ["single", "double", "frvsr"])
def test_pipeline_batches_match_jax(dataset, mode):
    need_blur = mode != "single"
    got = _batches(TrainPipeline, load_manifest(dataset, 4, need_blur), mode, 3)
    want = _batches(JTrainPipeline, j_load_manifest(dataset, 4, need_blur), mode, 3)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert g[k].dtype == np.uint8
            np.testing.assert_array_equal(g[k], w[k])
    assert got[0]["gt"].shape == ((2, 3, 32, 32, 3) if mode != "double" else (2, 1, 32, 32, 3))


def test_pipeline_reads_memory_frames(dataset):
    """The same frames held in memory give the same batches as the PNGs."""
    seqs = load_manifest(dataset)
    mem = MemoryFrames({p: imread(p) for s in seqs for p in s.truth})
    got = _batches(TrainPipeline, seqs, "single", 2, source=mem)
    want = _batches(TrainPipeline, seqs, "single", 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["gt"], w["gt"])


def test_pipeline_close_stops_its_threads(dataset):
    pipe = TrainPipeline(load_manifest(dataset), "single", 3, 8, 4, 2, num_threads=2)
    pipe.get_batch()
    pipe.close()
    assert not any(t.is_alive() for t in pipe._threads)


def _uint8_batch(b, t, s, seed):
    return (np.random.default_rng(seed).random((b, t, s, s, 3)) * 255).astype(np.uint8)


def test_augment_and_degrade_single_matches_jax():
    """The flips the generator draws, fed to the JAX package's _flip_clip,
    then its blur + decimation; atol 1e-6."""
    gt8 = _uint8_batch(16, 3, 32, 0)
    flips = torch.rand((16, 3), generator=torch.Generator().manual_seed(5)) < 0.5
    assert len({tuple(f) for f in flips.tolist()}) >= 6  # most combinations occur
    lr, center = device_augment_and_degrade({"gt": torch.from_numpy(gt8)},
                                            torch.Generator().manual_seed(5), "single", 4)
    gt = jnp.asarray(gt8).astype(jnp.float32) / 255.0
    f = jnp.asarray(flips.numpy())
    gt = jax.vmap(j_flip_clip)(gt, f[:, 0], f[:, 1], f[:, 2])
    assert lr.shape == (16, 3, 8, 8, 3) and center.shape == (16, 1, 32, 32, 3)
    np.testing.assert_allclose(lr.numpy(), np.asarray(j_downsample(gt, scale=4)), atol=1e-6)
    np.testing.assert_allclose(center.numpy(), np.asarray(gt[:, 1:2]), atol=1e-6)


@pytest.mark.parametrize("mode", ["double", "frvsr"])
def test_augment_and_degrade_lr_modes_match_jax(mode):
    lr8, gt8 = _uint8_batch(4, 3, 8, 1), _uint8_batch(4, 1, 32, 2)
    got = device_augment_and_degrade({"lr": torch.from_numpy(lr8), "gt": torch.from_numpy(gt8)},
                                     None, mode, 4)
    want = j_device_augment_and_degrade({"lr": jnp.asarray(lr8), "gt": jnp.asarray(gt8)},
                                        jax.random.PRNGKey(0), mode, 4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_augment_draws_its_flips_from_the_generator():
    batch = {"gt": torch.from_numpy(_uint8_batch(16, 3, 16, 3))}
    run = lambda seed: device_augment_and_degrade(  # noqa: E731
        batch, torch.Generator().manual_seed(seed), "single", 4)[1]
    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    unflipped = device_augment_and_degrade(batch, None, "single", 4, augment=False)[1]
    assert not torch.equal(run(5), unflipped)
