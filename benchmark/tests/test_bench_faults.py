"""`correct` comes out true for a sound run and false with the timed path
broken underneath, at a size the CPU runs (the harness's look for a chip
skipped); and the control, the reference at the precision below the
configuration's in the program's place, fails the limits: at a tiny size
here, at the cell's own size on the card (`gpu`).  The cells come from the
manifest: a cell added there is checked here with no edit."""

import pytest
import torch

import bench_tiny
from benchmark import core

SERVING = bench_tiny.serving_cells()
TRAINING = bench_tiny.training_cells()


@pytest.mark.parametrize("cell", bench_tiny.one_per_pair())
def test_a_sound_run_is_correct(cell):
    spec, rec = bench_tiny.run(cell)
    correct, checks = core.judge(rec, spec["limits"])
    assert correct, checks
    assert rec["attempted"] > 0 and rec["failed"] == 0


@pytest.mark.parametrize("cell", SERVING)
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    from pfnl_tpu_torch.infer import predictor

    serve = predictor.serve

    def altered(model, clip, plain=False):
        out = serve(model, clip, plain).clone()
        out[0] = out[0] + 0.05          # the batch's first frame, 13 uint8 levels off
        return out

    monkeypatch.setattr(predictor, "serve", altered)
    spec, rec = bench_tiny.run(cell)
    assert not core.judge(rec, spec["limits"])[0], rec["checks"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from pfnl_tpu_torch.train.trainer import Trainer

    def no_update(self):
        self.global_step += 1

    monkeypatch.setattr(Trainer, "apply_gradients", no_update)
    for cell in TRAINING:
        spec, rec = bench_tiny.run(cell)
        correct, checks = core.judge(rec, spec["limits"])
        assert not correct and checks["median_change_gap"]["value"] > 0.5, (cell, checks)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    """The loss of the cell's own model over the first half of the batch."""
    from pfnl_tpu_torch.train import losses

    for cell in TRAINING:
        model = core.cell(cell)["config"]["model"]
        full = losses.LOSS_REGISTRY[model]

        def half(out, gt, lr, full=full):
            b = gt.shape[0] // 2
            kept = {k: v[:b] if torch.is_tensor(v) and v.shape[0] == gt.shape[0] else v
                    for k, v in out.items()}
            return full(kept, gt[:b], lr[:b])

        with monkeypatch.context() as m:
            m.setitem(losses.LOSS_REGISTRY, model, half)
            spec, rec = bench_tiny.run(cell)
        assert not core.judge(rec, spec["limits"])[0], (cell, rec["checks"])


@pytest.mark.parametrize("cell", SERVING)
def test_the_control_fails_at_a_tiny_size(cell):
    spec = bench_tiny.spec(cell)
    checks = {"worst_frame_rms": core.driver(spec["traffic"]).control(bench_tiny.context(spec))}
    assert any(checks[k] > limit for k, limit in spec["limits"].items()), checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", bench_tiny.every_cell())
def test_the_control_fails_at_the_cells_size(cell, cuda):
    spec = core.cell(cell)
    ctx = core.Context(spec, 2 ** 31 + 77, 1.0, False, cuda, 0.0)
    got = core.driver(spec["traffic"]).control(ctx)
    checks = got if isinstance(got, dict) else {"worst_frame_rms": got}
    assert any(checks[k] > limit for k, limit in spec["limits"].items()), checks
