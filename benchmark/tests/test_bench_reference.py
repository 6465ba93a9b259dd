"""The references against the program's plain path at a tiny size (this
test imports both; benchmark/reference imports nothing of the program)."""

import ast
import os

import pytest
import torch

import bench_tiny
from benchmark import core, weights
from benchmark.reference import duf, ops, pfnl, train

REF_DIR = os.path.join(core.ROOT, "benchmark", "reference")


@pytest.mark.parametrize("path", sorted(f for f in os.listdir(REF_DIR) if f.endswith(".py")))
def test_the_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(open(os.path.join(REF_DIR, path)).read())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for n in names:
            assert n.split(".")[0] not in core.FORBIDDEN + ("pfnl_tpu_torch",), (path, n)


@pytest.mark.parametrize("entry", core.manifest()["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_reference_padded_as_the_program_pads(entry):
    from pfnl_tpu_torch.models import MODEL_REGISTRY

    spec = core.cell(entry["name"])
    cfg = spec["config"]
    if spec["traffic"]["driver"] == "fit":
        assert callable(core.reference(cfg, needs=("train_loss",)).train_loss)
    else:
        plain = core.reference(cfg, needs=("LR_MULTIPLE", "serve"))
        assert plain.LR_MULTIPLE == MODEL_REGISTRY[cfg["model"]].lr_multiple


def _x(shape, seed=4):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def test_pfnl_reference_is_the_programs_plain_forward():
    from pfnl_tpu_torch.infer.predictor import serve

    cfg = bench_tiny.spec("pfnl.udm10")["config"]
    model, w = weights.build(cfg, torch.float32, "cpu", 21)
    x = _x((2, 7, 12, 16, 3))
    with torch.no_grad():
        got = serve(model, x, plain=True)
        ref = pfnl.forward(w, x, cfg["num_blocks"])
        assert torch.equal(pfnl.serve(w, x, cfg, ops.FLOAT32), ref)
    assert got.shape == ref.shape == (2, 48, 64, 3)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_pfnl_reference_streams_attention_above_the_dense_limit():
    """Above 4096 positions the program streams key blocks; the reference
    takes query blocks: the same softmax."""
    th, g = _x((1, 5000, 12)), _x((1, 5000, 12), 5)
    from pfnl_tpu_torch.ops.nonlocal_attn import nonlocal_attention_chunked

    assert torch.allclose(ops.attention(th, th, g, block=1024),
                          nonlocal_attention_chunked(th, th, g), atol=1e-5)


def test_duf_reference_is_the_programs_plain_forward():
    from pfnl_tpu_torch.infer.predictor import serve

    cfg = bench_tiny.spec("duf52l.udm10")["config"]
    model, w = weights.build(cfg, torch.float32, "cpu", 22)
    model.eval()
    x = _x((1, 7, 8, 10, 3))
    with torch.no_grad():
        got = serve(model, x, plain=True)
        ref = duf.forward(w, x, cfg["same_blocks"], cfg["valid_blocks"], cfg["scale"])
        assert torch.equal(duf.serve(w, x, cfg, ops.FLOAT32), ref)
    assert got.shape == ref.shape == (1, 32, 40, 3)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_training_reference_is_the_programs_step():
    """Three Trainer steps against the reference's, from the same weights,
    batches and flips."""
    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.train.trainer import Trainer

    cfg = bench_tiny.spec(bench_tiny.training_cells()[0])["config"]
    model, w0 = weights.build(cfg, torch.float32, "cpu", 23)
    tr = cfg["train"]
    pcfg = preset("pfnl", reload=False, seed=5, batch_size=2, in_size=8)
    trainer = Trainer(pcfg, workdir="unused", model=model, device="cpu")
    batches = [(_x((2, 7, 32, 32, 3), 30 + k) * 255).to(torch.uint8) for k in range(3)]
    losses = [float(trainer.step({"gt": b.numpy()}, trainer.step_generator(k))["loss"])
              for k, b in enumerate(batches)]
    ref_losses, _, ref_p = train.run(pfnl, w0, batches, 5, cfg,
                                     (tr["learning_rate"], tr["end_lr"], tr["decay_power"],
                                      int(tr["decay_step"])))
    assert losses == pytest.approx(ref_losses, rel=1e-5)
    for n, p in trainer.model.named_parameters():
        change, ref_change = (p - w0[n]).norm(), (ref_p[n] - w0[n]).norm()
        assert abs(change - ref_change) <= 1e-4 * ref_change + 1e-9, n
