"""The rest of a run with the timed path broken underneath: ``correct``
comes out false for each fault a cell can have.  Rehearsals on the CPU
(``portbench.rehearse``: the cell's driver, check and limits, tiny
sizes); the look for a card is the only step left out."""

import numpy as np
import pytest
import torch

from portbench.rehearse import rehearse
from portbench.tests.test_pb_traffic import AGENT, DOCQA


def _alter_tokens(engine):
    """A token altered where it is produced: every third sampling call
    emits the next id after the greedy one."""
    sample, calls = engine._sample_plain, [0]

    def altered(logits, samp, noise):
        out = sample(logits, samp, noise)
        calls[0] += 1
        return (out + 1) % logits.shape[-1] if calls[0] % 3 == 0 else out
    engine._sample_plain = altered


def _drop_half_the_slots(engine):
    """Rows left out of a decode step: every slot is served the token the
    step computed for the row beside it, as when a kernel covers the wrong
    rows (whichever slots are active, each is hit)."""
    decode = engine._decode_call

    def shifted(last, temps, mask):
        return np.roll(decode(last, temps, mask), 1)
    engine._decode_call = shifted


def _unchanged_state(step):
    def stuck(state, batch):
        return state, step(state, batch)[1]
    return stuck


def _half_batch(step):
    def half(state, batch):
        n = batch["tokens"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()})
    return half


# The serving cell with its own mix, and with the mixes of the kinds a
# later cell would bring (shared documents; sessions whose later turns
# carry the turns before them).
SERVE = [("mistral7b.chat", None), ("mistral7b.chat", DOCQA),
         ("mistral7b.chat", dict(AGENT, turns={"min": 2, "max": 2}))]
SERVE_IDS = ["chat", "chat-docqa", "chat-agent"]
TRAIN = [("smollm2.train-2k", None)]


@pytest.mark.parametrize("cell,mix", SERVE + TRAIN,
                         ids=SERVE_IDS + ["train-2k"])
def test_a_sound_run_reads_far_below_the_faults(cell, mix):
    """Sound serving runs pass the cell's limits at tiny sizes.  A tiny
    training step's bf16 round-off is a larger share of its small leaves
    than at the published widths, so there the sound numbers are held
    within 10x of the limits, which the faults exceed by far more."""
    record, metrics = rehearse(cell, seed=2 ** 31 + 3, seconds=1.5, mix=mix)
    if (cell, mix) in SERVE:
        assert record["correct"] is True, record["checked"]
        kv = record["kv"]
        assert 0 < kv["written_blocks"] <= kv["pool_blocks"]
    assert all(c["value"] < 10 * c["limit"]
               for c in record["checked"].values()), record["checked"]
    assert record["attempted"] > 0 and record["failed"] == 0
    assert "setup_s" in metrics


@pytest.mark.parametrize("cell,mix", SERVE, ids=SERVE_IDS)
@pytest.mark.parametrize("fault", [_alter_tokens, _drop_half_the_slots])
def test_serve_faults_are_caught(cell, mix, fault):
    record, _ = rehearse(cell, seed=11, seconds=1.5, mix=mix,
                         options={"engine_hooks": [fault]})
    assert record["correct"] is False, record["checked"]


@pytest.mark.parametrize("cell,mix", TRAIN, ids=["train-2k"])
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch])
def test_train_faults_are_caught(cell, mix, fault):
    record, _ = rehearse(cell, seed=12, seconds=1.0,
                         options={"step_hooks": [fault]})
    assert record["correct"] is False, record["checked"]


def test_the_measurement_refuses_the_cpu(monkeypatch, capsys):
    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "mistral7b.chat", "--seed", "1",
                     "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
