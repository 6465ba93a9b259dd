"""The port's random init against flax's, on the CPU: the truncated-normal
draw (models/blocks.truncated_normal) pinned at seed 0 and held against a
float64 numpy evaluation of its formula, and each family's seeded model at
its full-width paper configuration against the flax model's `init`: the
same names, shapes and zero-initialised parameters, and the same spread
in every random tensor.  chip_smoke.py phase 21 recomputes the pins on the
card's torch."""

import glob
import hashlib
import math
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.special
import torch

torch.set_num_threads(2)

from pfnl_tpu.config import preset
from pfnl_tpu.models import MODEL_REGISTRY as J_MODEL_REGISTRY

import chip_smoke
from pfnl_tpu_torch.models import MODEL_REGISTRY, blocks, duf
from pfnl_tpu_torch.models.blocks import TRUNC_STD, conv_lecun, truncated_normal
from pfnl_tpu_torch.models.duf import he_trunc_normal
from pfnl_tpu_torch.ops.convlstm import _Gates
from pfnl_tpu_torch.utils.weights import to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# seed 0: (shape, the untruncated std, the first eight values, the exact float64 sum
# (math.fsum), the sha256 of the float32 bytes)
PINS = {
    "conv_lecun": ((3, 3, 128, 128), math.sqrt(1 / (9 * 128)) / TRUNC_STD, [
        -0.0002999955613631755, 0.02323022298514843, -0.04158523306250572,
        -0.034891728311777115, -0.016023634001612663, 0.010936112143099308,
        -0.0007939743809401989, 0.03909021615982056], 4.38929295702161,
        "a2bc4f50762f8a2750823f98da6b9afd45958f77bdd373c4407947a6c8faf49a"),
    "he_trunc_normal": ((3, 3, 3, 64, 16), math.sqrt(2 / (27 * 64)) / TRUNC_STD, [
        -0.0003464050532784313, 0.026823950931429863, -0.04801849275827408,
        -0.0402894988656044, -0.018502498045563698, 0.012627935037016869,
        -0.0009168026153929532, 0.045137494802474976], 7.208792638101841,
        "6251aab55c2398d29af769a025323ff1945870bafba417b2ef8e211be936016c"),
    "gates": ((3, 3, 256, 512), 1e-3, [
        -8.956512829172425e-06, 0.0006935495766811073, -0.0012415472883731127,
        -0.0010417094454169273, -0.000478393369121477, 0.0003265029226895422,
        -2.370448964938987e-05, 0.0011670573148876429], 0.05346113455988655,
        "f454c544f25c6640d7a4558105e986efe35270650462606f2afbed26d7a25153"),
}


def _draw(name):
    """The pinned draw: DRVSR's ConvLSTM gates (256 inputs, 128 features)
    for "gates"."""
    gen = torch.Generator().manual_seed(0)
    shape = PINS[name][0]
    if name == "gates":
        return _Gates(3, shape[2], shape[3], gen).kernel.detach()
    return {"conv_lecun": conv_lecun, "he_trunc_normal": he_trunc_normal}[name](shape, gen)


@pytest.mark.parametrize("name", sorted(PINS))
def test_draw_is_pinned(name):
    """Shape, float32, the first eight values, the exact sum and the digest
    of the bytes equal the literals."""
    shape, _, first, total, digest = PINS[name]
    w = _draw(name)
    assert tuple(w.shape) == shape and w.dtype == torch.float32
    assert [float(v) for v in w.flatten()[:8]] == first
    assert math.fsum(w.double().flatten().tolist()) == total
    assert hashlib.sha256(w.contiguous().numpy().tobytes()).hexdigest() == digest


@pytest.mark.parametrize("name", sorted(PINS))
def test_draw_follows_the_formula_in_float64(name):
    """The whole draw within one float32 ulp of numpy's float64 evaluation
    of sqrt(2) erfinv(lo + (hi - lo) u) std on the same torch.rand values,
    clamped to two std, and no value past two std."""
    shape, std, *_ = PINS[name]
    u = torch.rand(shape, generator=torch.Generator().manual_seed(0)).numpy().astype(np.float64)
    lo, hi = math.erf(-math.sqrt(2.0)), math.erf(math.sqrt(2.0))
    want = np.clip(np.sqrt(2.0) * scipy.special.erfinv(lo + (hi - lo) * u) * std, -2 * std, 2 * std)
    got = _draw(name).numpy().astype(np.float64)
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(got - want) <= ulp)
    assert np.abs(got).max() <= 2 * std


def test_draw_takes_one_uniform_a_value():
    """The generator moves on by exactly the draw's torch.rand, whatever the
    values: the next value after a draw equals the next after torch.rand."""
    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    truncated_normal((1000,), 1.0, a)
    torch.rand((1000,), generator=b)
    assert torch.equal(torch.rand(8, generator=a), torch.rand(8, generator=b))


def test_chip_smoke_holds_the_same_pins():
    """Phase 21 checks the card's draws against these literals."""
    assert chip_smoke.INIT_PINS == {k: (v[0], v[2], v[3], v[4]) for k, v in PINS.items()}


def test_no_port_module_calls_torch_trunc_normal():
    """Every truncated normal of the port goes through truncated_normal."""
    pattern = re.compile(r"trunc_normal_\s*\(")
    hits = [p for p in glob.glob(os.path.join(ROOT, "pfnl_tpu_torch", "**", "*.py"),
                                 recursive=True) if pattern.search(open(p).read())]
    assert hits == []


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v, np.float64)
    return out


def _rel_se_of_std(x):
    """The standard error of a sample std over the std, from the sample's
    kurtosis k: sqrt((k - 1) / 4n)."""
    x = x.ravel() - x.mean()
    m2 = np.mean(x ** 2)
    return math.sqrt((np.mean(x ** 4) / m2 ** 2 - 1) / (4 * x.size))


# the LR side flax's init traces at: DUF-52L's trace is the slow one, so the least
INIT_SIDE = {"duf": 1}


@pytest.mark.parametrize("family", ["pfnl", "vespcn", "ltdvsr", "mcresnet", "drvsr", "frvsr",
                                    "duf"])
def test_seeded_init_matches_flax_init(family, monkeypatch):
    """At the family's full-width paper configuration (the preset's frames,
    x4), the port's seed-0 model against flax's init(PRNGKey(0)): the same
    names and shapes (utils/weights.to_flax), the same zero-initialised and
    constant parameters; in every random tensor of at least 4096 values a
    std within 3% of flax's (or, for a tensor too small for that, within
    four standard errors of the difference of two draws' stds: at 4096
    truncated-normal values one standard error is 1.3%) and a mean within
    four standard errors of 0; and no value of a truncated-normal draw past
    two std."""
    cfg = preset(family)
    side = INIT_SIDE.get(family, 8)
    x = jnp.zeros((1, cfg.num_frames, side, side, 3), jnp.float32)
    jm = J_MODEL_REGISTRY[family](num_frames=cfg.num_frames, scale=cfg.scale)
    kw = {"is_train": True} if family == "duf" else {}
    variables = jax.jit(lambda key, x: jm.init(key, x, **kw))(jax.random.PRNGKey(0), x)
    want = _flat(variables["params"])

    draws = []

    def spy(shape, std, generator=None):
        out = truncated_normal(shape, std, generator)
        draws.append((out, std))
        return out

    monkeypatch.setattr(blocks, "truncated_normal", spy)
    monkeypatch.setattr(duf, "truncated_normal", spy)
    model = MODEL_REGISTRY[family](num_frames=cfg.num_frames, scale=cfg.scale,
                                   generator=torch.Generator().manual_seed(0))
    params, _ = to_flax(model)
    got = _flat(params)

    assert sorted(got) == sorted(want)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    zeros = sorted(k for k, v in want.items() if not v.any())
    assert sorted(k for k, v in got.items() if not v.any()) == zeros
    for k, w in want.items():
        if w.std() == 0:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    random = [k for k, w in want.items() if w.std() > 0 and w.size >= 4096]
    assert random
    for k in random:
        g, w = got[k], want[k]
        tol = max(0.03, 4 * math.hypot(_rel_se_of_std(g), _rel_se_of_std(w)))
        assert abs(g.std() / w.std() - 1) <= tol, (k, g.std(), w.std(), tol)
        assert abs(g.mean()) <= 4 * g.std() / math.sqrt(g.size), (k, g.mean())

    ptrs = {p.data_ptr() for p in model.parameters()}
    assert bool(draws) == (family in ("drvsr", "frvsr", "duf"))
    for out, std in draws:
        assert out.data_ptr() in ptrs
        assert out.abs().max().item() <= 2 * std
