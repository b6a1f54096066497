"""The harness finds every piece by name, and refuses settings that nothing
reads."""

import copy

import pytest

from portbench import harness
from portbench.drivers import serve
from portbench.rehearse import rehearse

BENCH = harness.benchmark()


@pytest.mark.parametrize("entry", BENCH["workloads"],
                         ids=[w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_and_agrees_with_the_benchmark(entry):
    ctx = harness.context(entry["name"], 1, 1.0, False, 0.0)
    assert all(ctx.cell[k] == entry[k] for k in ("config", "traffic",
                                                  "chips"))
    fam = harness.family(ctx.config)
    assert fam.dims(ctx.config).vocab == ctx.config["vocab_size"]
    assert harness.metrics_of(BENCH, entry["name"], False)
    assert harness.metrics_of(BENCH, entry["name"], True)


def test_a_cell_key_that_nothing_reads_is_refused():
    ctx = harness.context("mistral7b.chat", 1, 1.0, False, 0.0)
    bad = copy.copy(ctx)
    bad.cell = dict(ctx.cell, kv_dtype="int8")
    with pytest.raises(SystemExit, match="read by nothing"):
        harness.check_keys(bad)
    bad.cell = dict(ctx.cell)
    bad.mix = dict(ctx.mix, greedy=False)
    with pytest.raises(ValueError, match="read by nothing"):
        harness.check_keys(bad)


def test_an_engine_option_the_port_lacks_fails_before_any_request():
    with pytest.raises(TypeError, match="kv_dtype"):
        rehearse("mistral7b.chat", seed=1, seconds=0.5,
                 options={"engine": {"kv_dtype": "int8"}})


def test_a_family_whose_equations_differ_is_refused():
    ctx = harness.context("mistral7b.chat", 1, 1.0, False, 0.0)
    fam = harness.family(ctx.config)
    with pytest.raises(ValueError, match="not Llama's"):
        fam.dims(dict(ctx.config, sliding_window=4096))


def test_blocks_written_follow_the_allocator():
    from kuberay_tpu_torch.serve.paged_kv import BlockAllocator

    a = BlockAllocator(10, 16)
    assert serve.kv_blocks_written(a) == 0
    got = [a.allocate() for _ in range(4)]
    assert serve.kv_blocks_written(a) == 4
    for b in got[:3]:
        a.free(b)
    assert serve.kv_blocks_written(a) == 4
    more = [a.allocate() for _ in range(7)]
    assert serve.kv_blocks_written(a) == 10 and None not in more
