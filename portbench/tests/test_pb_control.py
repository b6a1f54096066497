"""The controls, run on the card at a size a test run holds, through the
cell's own driver and check (``portbench.rehearse``: the cell's traffic
shortened).

Serving: the whole published model.  The program passes the cell's limit;
the program's own lower-precision path, W8A16 weights, is judged not
correct by the cell's check at that limit (``check.verdict``); and the
reference in fp8 (``Lowp``), put in the program's place, reads at least
three times what the program reads.  Training: four layers of the
published widths; the fp8 reference reads at least three times the
program on one of the cell's numbers.  The cell-size readings behind the
limits are in PERF.md (``python3 -m portbench.control``)."""

import pytest
import torch

from portbench import check, harness
from portbench.rehearse import rehearse
from portbench.traffic import generate

FOUR_LAYERS = {"num_hidden_layers": 4}
WHOLE = {}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_serve_control_is_not_correct():
    _card()
    record, _ = rehearse("mistral7b.chat", seed=5, seconds=3.0,
                         options={"keep_samples": True}, device="cuda",
                         sizes=WHOLE)
    assert record["correct"] is True, record["checked"]
    ctx = harness.context("mistral7b.chat", 5, 1.0, False, 0.0)
    fam = harness.family(ctx.config)
    params = fam.make_params(ctx.config, 5, "cuda", fam.dtype(ctx.config))
    low = check.serve_numbers(fam, params, ctx.config, record["samples"],
                              lowp=fam.Lowp("fp8"))
    del params
    sound = record["numbers"]["served_gap_mean"]
    assert low["served_gap_mean"] > 0
    assert low["served_gap_mean"] >= 3 * sound
    int8w, _ = rehearse("mistral7b.chat", seed=5, seconds=3.0,
                        options={"engine": {"weight_quant": "int8"}},
                        device="cuda", sizes=WHOLE)
    ok, checked = check.verdict(int8w["numbers"],
                                ctx.cell["check"]["limits"])
    assert ok is False and int8w["correct"] is False, checked


@pytest.mark.gpu
def test_train_control_reads_above_the_program():
    _card()
    record, _ = rehearse("smollm2.train-2k", seed=6, seconds=2.0,
                         device="cuda", sizes=FOUR_LAYERS)
    ctx = harness.context("smollm2.train-2k", 6, 1.0, False, 0.0)
    config = dict(ctx.config, **FOUR_LAYERS)
    fam = harness.family(config)
    mix = dict(ctx.mix, batch=2, seq_len=32, pool=4)
    batches = list(generate.batches(mix, fam.dims(config).vocab, 6,
                                    "cuda")[:3])
    p0 = fam.make_params(config, 6, "cuda", torch.float32)
    low = fam.reference_train(p0, config, batches, fam.Lowp("fp8"))
    got = check.train_numbers(low, record["reference"])
    assert any(got[k] >= 3 * record["numbers"][k] for k in got)
