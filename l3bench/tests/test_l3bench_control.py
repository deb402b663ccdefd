"""The controls fail the cells' limits: the plain reference, put in the
program's place and computed in the nearest precision below the cell's
(fp8 below bf16, TF32 below float32 with TF32 off), and, for the bf16
extraction cell, the program's own int8 path. On the CPU at a small size;
the TF32 control needs the card."""

import numpy as np
import pytest
import torch

from l3bench import check, run, weights
from l3bench.drivers import extract
from l3bench.generators import avc_batches, clips
from l3bench.reference import model as ref


def _extraction_numbers(errs):
    return {"bad_counts": 0, "row_err": float(errs.max()), "clip_err": check.clip_err([errs]),
            "clip_p90": check.clip_p90([errs]), "clip_mean": check.clip_mean([errs]),
            "row_err_median": float(np.median(errs))}


def _extraction_control(workload, prec, device):
    _, entry, cell, cfg, mix = run.load_cell(workload)
    pooling = cell["options"]["pooling"]
    params = weights.make(ref.param_specs(cfg, ("audio",)), 17, device)
    stream = clips.ClipStream(mix, 17, device)
    x = torch.from_numpy(ref.frame_windows(stream.pool[:48000 * 2], 48000, 0.1)[:4]).to(device)
    with torch.no_grad():
        want = ref.audio_embedding(params, x, cfg, pooling, "f32").cpu().numpy()
        got = ref.audio_embedding(params, x, cfg, pooling, prec).cpu().numpy()
    return check.verdict(_extraction_numbers(check.row_errs(got, want)), cell["check"]["limits"])


def test_fp8_control_fails_the_bf16_extraction_cell():
    ok, table = _extraction_control("mel256.extract.bf16", "fp8", "cpu")
    assert not ok, table


def test_the_programs_int8_path_fails_the_bf16_extraction_cell(monkeypatch):
    import l3embedding_torch.embed.extract as program_extract

    monkeypatch.setattr(program_extract, "BUCKETS", (2, 4, 8))
    _, entry, cell, cfg, mix = run.load_cell("mel256.extract.bf16")
    mix = {**mix, "lengths": {"fixed": [[1.5, 2]]}, "pool_seconds": 4}
    params = weights.make(ref.param_specs(cfg, ("audio",)), 17, "cpu")
    stream = clips.ClipStream(mix, 17, "cpu")
    q8 = extract.int8_extractor(params, stream, cfg, "short", 0.1, "cpu")
    errs = np.concatenate([check.row_errs(q8.embed_audio(stream.clip(k), 0.1),
                                          extract.reference_rows(params, stream, k, cfg, "short", 0.1, "cpu", "f32"))
                           for k in range(2)])
    ok, table = check.verdict(_extraction_numbers(errs), cell["check"]["limits"])
    assert not ok, table


@pytest.mark.cuda
def test_tf32_control_fails_the_f32_extraction_cell():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on the card only")
    ok, table = _extraction_control("linear.extract.f32", "tf32", "cuda")
    assert not ok, table


def test_fp8_control_fails_the_training_cell():
    _, entry, cell, cfg, mix = run.load_cell("mel256.train.bf16")
    params = weights.make(ref.param_specs(cfg), 8, "cpu")
    batches = avc_batches.avc_pool({**mix, "rows_per_card": 4, "pool": 3}, 8, "cpu", 2)
    want = ref.train_steps(params, batches, cfg, "f32")
    got = ref.train_steps(params, batches, cfg, "fp8")
    numbers = check.train_numbers(got, want, params)
    ok, table = check.verdict(numbers, cell["check"]["limits"])
    assert not ok, table
    assert numbers["emb_err"] > cell["check"]["limits"]["emb_err"], table


def test_the_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.linspace(-3, 3, 1001)
    q = ref.e4m3(x)
    assert torch.all(torch.abs(q - x) <= torch.abs(x) / 16 + 3 / 448 / 8)
    assert not torch.equal(q, x)
    assert np.isclose(float(q.abs().max()), 3.0)
