"""`correct` comes out true for a sound run and false with the timed path
broken underneath, at a size the CPU runs (the harness's look for a chip
skipped); and the control, the reference at the precision below the
configuration's in the program's place, fails the limits: at a tiny size
here, at the cell's own size on the card (`gpu`)."""

import pytest

import bench_tiny
from benchmark import core

SERVING = ["pfnl.udm10", "duf52l.udm10"]


@pytest.mark.parametrize("cell", SERVING + ["pfnl.train"])
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
    spec, rec = bench_tiny.run("pfnl.train")
    correct, checks = core.judge(rec, spec["limits"])
    assert not correct and checks["median_change_gap"]["value"] > 0.5, checks


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from pfnl_tpu_torch.train import losses

    full = losses.LOSS_REGISTRY["pfnl"]

    def half(out, gt, lr):
        b = gt.shape[0] // 2
        return full({"sr": out["sr"][:b]}, gt[:b], lr[:b])

    monkeypatch.setitem(losses.LOSS_REGISTRY, "pfnl", half)
    spec, rec = bench_tiny.run("pfnl.train")
    assert not core.judge(rec, spec["limits"])[0], rec["checks"]


@pytest.mark.parametrize("cell", SERVING)
def test_the_control_fails_at_a_tiny_size(cell):
    spec = bench_tiny.spec(cell)
    checks = {"worst_frame_rms": core.driver(spec["traffic"]).control(bench_tiny.context(spec))}
    assert any(checks[k] > limit for k, limit in spec["limits"].items()), checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", SERVING + ["pfnl.uhd4k", "pfnl.train"])
def test_the_control_fails_at_the_cells_size(cell, cuda):
    spec = core.cell(cell)
    ctx = core.Context(spec, 2 ** 31 + 77, 1.0, False, cuda, 0.0)
    got = core.driver(spec["traffic"]).control(ctx)
    checks = got if isinstance(got, dict) else {"worst_frame_rms": got}
    assert any(checks[k] > limit for k, limit in spec["limits"].items()), checks
