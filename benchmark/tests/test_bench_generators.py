"""The traffic is a function of the seed: the same seed, the same inputs."""

import collections

import numpy as np
import torch

import bench_tiny
from benchmark import core, scenes, weights
from benchmark.drivers import clips, fit


def test_scenes_are_deterministic_for_a_seed():
    a = scenes.make(2, 6, 20, 28, 2 ** 31 + 5, "cpu")
    b = scenes.make(2, 6, 20, 28, 2 ** 31 + 5, "cpu")
    c = scenes.make(2, 6, 20, 28, 2 ** 31 + 6, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (2, 6, 20, 28, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert (a[:, 1:].float() - a[:, :-1].float()).abs().mean() > 1.0  # it moves


def test_clip_plan_is_deterministic_and_the_same_mix_for_every_seed():
    traffic = core.cell("pfnl.udm10")["traffic"]
    lo, hi = traffic["clip_frames"]
    cycle = hi - lo + 1
    a, b = clips.plan(traffic, 7, 3 * cycle), clips.plan(traffic, 7, 3 * cycle)
    c = clips.plan(traffic, 8, 3 * cycle)
    assert a == b and a != c
    count = collections.Counter(L for L, _ in a)
    assert count == collections.Counter(L for L, _ in c)
    assert set(count) == set(range(lo, hi + 1)) and set(count.values()) == {3}
    assert clips.kept_frames(9, 3, 30) == clips.kept_frames(9, 3, 30)
    assert {0, 29} <= clips.kept_frames(9, 3, 30)


def test_training_sequences_are_deterministic_for_a_seed():
    spec = bench_tiny.spec(bench_tiny.training_cells()[0])
    store_a, seqs_a = fit.sequences(bench_tiny.context(spec))
    store_b, seqs_b = fit.sequences(bench_tiny.context(spec))
    assert [s.truth for s in seqs_a] == [s.truth for s in seqs_b]
    for p in seqs_a[0].truth:
        assert np.array_equal(store_a.read(p), store_b.read(p))
    _, seqs_c = fit.sequences(bench_tiny.context(spec, seed=bench_tiny.TINY_SEED + 1))
    store_c, _ = fit.sequences(bench_tiny.context(spec, seed=bench_tiny.TINY_SEED + 1))
    assert not np.array_equal(store_a.read(seqs_a[0].truth[0]), store_c.read(seqs_c[0].truth[0]))


def test_weights_are_deterministic_for_a_seed_and_loaded_unchanged():
    cfg = bench_tiny.spec("duf52l.udm10")["config"]
    model, w = weights.build(cfg, torch.bfloat16, "cpu", 11)
    _, w2 = weights.build(cfg, torch.bfloat16, "cpu", 11)
    _, w3 = weights.build(cfg, torch.bfloat16, "cpu", 12)
    state = model.state_dict()
    assert set(w) == set(state)
    assert all(torch.equal(w[k], w2[k]) and torch.equal(w[k], state[k]) for k in w)
    assert not torch.equal(w["G.conv1.W"], w3["G.conv1.W"])
    assert float(w["G.Rbn1a.moving_variance"].min()) >= 0.5
