"""The seeded traffic generator, each kind read from data alone."""

import numpy as np
import pytest

from portbench.harness import HERE, read_json
from portbench.traffic import generate

CHAT = read_json(HERE / "traffic" / "chat.json")
# Document Q&A, as a later cell would add it (PERF.md, section 7).
DOCQA = {"kind": "open_loop", "rate_per_s": 2.0, "sizes_seed": 20240602,
         "pool": 4096,
         "documents": {"count": 8, "min": 3072, "max": 6144, "zipf_s": 1.1},
         "prompt": {"dist": "uniform", "min": 16, "max": 256},
         "output": {"dist": "uniform", "min": 32, "max": 256},
         "temperature": 0.0}
# An agent's sessions over a long shared system prompt.
AGENT = {"kind": "sessions", "rate_per_s": 0.5, "sizes_seed": 20240603,
         "pool": 512, "system": {"dist": "uniform", "min": 8192,
                                 "max": 16384},
         "turns": {"min": 2, "max": 6}, "think_s": 3.0,
         "prompt": {"dist": "lognormal", "median": 128, "sigma": 0.7,
                    "min": 16, "max": 1024},
         "output": {"dist": "lognormal", "median": 96, "sigma": 0.6,
                    "min": 16, "max": 512}}
# On/off bursts of chat.
BURST = dict(CHAT, arrivals={"process": "on_off", "on_s": 4.0,
                             "off_s": 12.0, "off_share": 0.0},
             rate_per_s=8.0)


def _key(plans):
    return [(p.due_s, p.prompt, p.max_tokens, p.document) for p in plans]


@pytest.mark.parametrize("mix", [CHAT, DOCQA], ids=["chat", "docqa"])
def test_same_seed_same_requests(mix):
    a = generate.schedule(mix, 32768, 2 ** 31 + 99, 30.0)
    b = generate.schedule(mix, 32768, 2 ** 31 + 99, 30.0)
    c = generate.schedule(mix, 32768, 5, 30.0)
    assert _key(a) == _key(b)
    assert _key(a) != _key(c)


def test_lengths_inside_their_clips():
    for seed in (1, 2, 3):
        for p in generate.schedule(CHAT, 32768, seed, 200.0):
            assert 32 <= len(p.prompt) <= 3072
            assert 16 <= p.max_tokens <= 1024
            assert all(0 <= t < 32768 for t in p.prompt[:50])


@pytest.mark.parametrize("mix", [CHAT, DOCQA], ids=["chat", "docqa"])
def test_every_seed_offers_the_same_work_at_the_same_times(mix):
    a, b = (generate.schedule(mix, 32768, seed, 300.0) for seed in (1, 2))
    assert [(p.due_s, len(p.prompt), p.max_tokens, p.document)
            for p in a] == [(p.due_s, len(p.prompt), p.max_tokens,
                             p.document) for p in b]
    assert [p.prompt for p in a] != [p.prompt for p in b]


def test_open_loop_due_times():
    plans = generate.schedule(CHAT, 32768, 7, 400.0, rate_per_s=5.0)
    due = [p.due_s for p in plans]
    assert due == sorted(due) and due[-1] < 400.0
    assert abs(len(plans) / 400.0 - 5.0) < 0.5
    faster = generate.schedule(CHAT, 32768, 7, 400.0, rate_per_s=10.0)
    assert faster[10].due_s == pytest.approx(plans[10].due_s / 2)


def test_docqa_documents_and_zipf():
    docs = generate.shared_prefixes(DOCQA, 32768, 3)
    assert len(docs) == 8 and all(3072 <= len(d) <= 6144 for d in docs)
    plans = generate.schedule(DOCQA, 32768, 3, 300.0)
    counts = np.bincount([p.document for p in plans], minlength=8)
    assert counts[0] == counts.max() and counts[0] > 2 * counts[7]
    for p in plans[:20]:
        doc = docs[p.document]
        assert p.prompt[:len(doc)] == doc
        assert 16 <= len(p.prompt) - len(doc) <= 256
        assert 32 <= p.max_tokens <= 256


def test_zipf_ranks_follow_the_law():
    ranks = generate.zipf_ranks(np.random.default_rng(0), 8, 1.1, 200000)
    p = 1.0 / np.arange(1, 9) ** 1.1
    np.testing.assert_allclose(np.bincount(ranks) / 200000, p / p.sum(),
                               atol=0.005)


def test_batches_are_seeded():
    mix = {"kind": "batches", "batch": 2, "seq_len": 8, "pool": 3}
    a = generate.batches(mix, 100, 2 ** 31 + 7, "cpu")
    b = generate.batches(mix, 100, 2 ** 31 + 7, "cpu")
    assert a.shape == (3, 2, 9) and bool((a == b).all())
    assert not bool((a[0] == a[1]).all())


def test_prefill_buckets_cover_the_longest_prompt():
    plans = generate.schedule(CHAT, 32768, 1, 120.0)
    buckets = generate.prefill_buckets(plans, 4096)
    assert buckets[0] == 32 and buckets[-1] >= max(len(p.prompt)
                                                   for p in plans)


def test_chat_is_the_schedule_measured_before_the_generator_split():
    """The split into kinds left chat's requests as they were: a digest
    of its schedule before the split, at two seeds and rates."""
    import hashlib
    import json

    def digest(plans):
        return hashlib.sha256(json.dumps(
            [(p.index, repr(p.due_s), p.prompt, p.max_tokens)
             for p in plans]).encode()).hexdigest()[:16]

    a = generate.schedule(CHAT, 32768, 2 ** 31 + 5, 120.0, rate_per_s=2.4)
    b = generate.schedule(CHAT, 32768, 7, 120.0, rate_per_s=3.0)
    assert (len(a), digest(a)) == (304, "8a138874320068ff")
    assert (len(b), digest(b)) == (386, "0f505ef1d35fed6b")


@pytest.mark.parametrize("mix", [CHAT, DOCQA, AGENT, BURST,
                                 read_json(HERE / "traffic" /
                                           "pretrain-2k.json")],
                         ids=["chat", "docqa", "agent", "burst", "train"])
def test_every_key_of_a_mix_is_read(mix):
    generate.check_keys(mix)
    with pytest.raises(ValueError, match="read by nothing"):
        generate.check_keys(dict(mix, greedy=True))


def test_an_unknown_kind_is_refused():
    with pytest.raises(ValueError, match="no traffic kind"):
        generate.schedule(dict(CHAT, kind="closed_loop"), 100, 1, 10.0)


def test_on_off_arrivals_come_only_while_on():
    plans = generate.schedule(BURST, 32768, 3, 160.0)
    phase = [p.due_s % 16.0 for p in plans]
    assert all(x < 4.0 for x in phase)
    # The same gaps, compressed into the on phases: rate 8 over a quarter
    # of the time, so about 2 a second over the whole.
    assert abs(len(plans) / 160.0 - 2.0) < 0.4
    half = generate.schedule(dict(BURST, arrivals=dict(
        BURST["arrivals"], off_share=0.5)), 32768, 3, 160.0)
    assert any(p.due_s % 16.0 >= 4.0 for p in half)


def test_sessions_chain_their_turns():
    plans = generate.schedule(AGENT, 32768, 4, 120.0)
    system = generate.shared_prefixes(AGENT, 32768, 4)[0]
    assert 8192 <= len(system) <= 16384
    firsts = [p for p in plans if p.after is None]
    assert abs(len(firsts) / 120.0 - 0.5) < 0.2
    for p in plans:
        if p.after is None:
            assert p.prompt[:len(system)] == system and p.think_s == 0.0
        else:
            prev = plans[p.after]
            assert prev.index == p.after < p.index
            assert p.think_s > 0 and p.due_s == prev.due_s
            assert p.bound == prev.bound + prev.max_tokens + len(p.prompt)
    turns = {p.index: 1 for p in firsts}
    root = {}
    for p in plans:
        root[p.index] = p.index if p.after is None else root[p.after]
        if p.after is not None:
            turns[root[p.index]] += 1
    assert set(turns.values()) <= set(range(2, 7))
    same = generate.schedule(AGENT, 32768, 5, 120.0)
    assert [(p.due_s, len(p.prompt), p.after) for p in plans] == \
        [(p.due_s, len(p.prompt), p.after) for p in same]


def test_repeated_ids_and_a_greedy_share():
    mix = dict(CHAT, ids={"dist": "repeat", "min": 8, "max": 8},
               temperature=0.7, greedy_share=0.25)
    plans = generate.schedule(mix, 32768, 6, 200.0)
    for p in plans[:20]:
        assert p.prompt[8:16] == p.prompt[:8] or len(p.prompt) < 16
    temps = np.array([p.temperature for p in plans])
    assert set(temps.tolist()) == {0.0, 0.7}
    assert abs((temps == 0.0).mean() - 0.25) < 0.1
    again = generate.schedule(mix, 32768, 9, 200.0)
    assert [p.temperature for p in again] == temps.tolist()
