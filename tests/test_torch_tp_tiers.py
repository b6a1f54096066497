"""PyTorch port, the KV tiers and the KV-block transfer under tensor
parallelism vs the JAX package.

One spawn of 4 gloo ranks (``torch_tp_tiers_worker.py``) runs a paged
engine with host and spill tiers as a tp=2 group (2 ranks) and as a tp=4
group (tp=2 x tpr=2 over ``llama_tiny``'s 2 kv heads), rank 0 a
``MultihostPagedServeEngine`` and the others ``follower_loop``; JAX runs
its ``PagedServeEngine`` on ``serve_mesh`` with the same tiers in this
process meanwhile.  On ``test_torch_kv_tiers.py``'s resume case:

- the greedy tokens of a session resumed after every device block was
  evicted, the ``tier-fetch`` span's blocks and every tier counter equal
  JAX's: the session resumes from the tiers without a prefill of its
  prefix;
- the export of the prompt (its blocks promoted back) has JAX's indices
  and hashes, and its payloads lie within 1e-5 of JAX's export (float32,
  as the tp tests' logits);
- the group imports a JAX export of another prompt (3 blocks) and serves
  it with JAX's cold tokens and 2 blocks of prefix hits;
- the group's export imports into a one-process replica of each package,
  which then serve the prompt's cold tokens;
- every follower replays each plan rank 0 broadcast, block plans among
  them, and holds no tier store.

The JAX engines decode on the XLA path (``decode_impl="xla"``).
"""

import base64

import jax
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.obs import Tracer as JTracer
from kuberay_tpu.serve import sharding as jsh
from kuberay_tpu.serve.engine import Request as JRequest
from kuberay_tpu.serve.paged_engine import PagedServeEngine as JPagedEngine
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.serve import multihost as tmh
from kuberay_tpu_torch.serve.engine import Request
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine

import torch_tp_tiers_worker as worker

torch.set_num_threads(2)

CFG = jllama.CONFIGS["llama_tiny"]
TCFG = tllama.CONFIGS["llama_tiny"]
BS, SLOTS, MAX_LEN = 8, 2, 64
PROMPT = list(range(1, 25))                      # 3 full blocks
IMPORT_PROMPT = list(range(100, 124)) + [7, 9]   # 3 full blocks and a tail
VARIANTS = [
    # The prompt's 3 blocks outgrow a host tier of 2: the spill tier
    # takes the rest.
    {"name": "tp2", "tp": 2, "host_blocks": 2, "spill_blocks": 48},
    {"name": "tp4_tpr2", "tp": 4, "host_blocks": 64, "spill_blocks": 8},
]
NAMES = [v["name"] for v in VARIANTS]
ATOL = 1e-5


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, dtype=np.float32)}


def _jengine(params, mesh=None, **kw):
    return JPagedEngine(CFG, params, max_slots=SLOTS, max_len=MAX_LEN,
                        block_size=BS, decode_impl="xla", mesh=mesh, **kw)


def _jserve(eng, rid, prompt, n, **kw):
    eng.add_request(JRequest(rid, list(prompt), max_new_tokens=n, **kw))
    return eng.run()[0].tokens


def _jax_resume(params, var, import_blocks):
    """JAX's side of the worker's ``lead``, on ``serve_mesh(tp)``."""
    eng = _jengine(params, jsh.serve_mesh(var["tp"],
                                          n_kv_heads=CFG.n_kv_heads),
                   host_blocks=var["host_blocks"],
                   spill_blocks=var["spill_blocks"])
    tracer = eng._tracer = JTracer()
    _jserve(eng, "p", PROMPT, 1)
    eng._pump_demotions(limit=1 << 10)
    st = eng.tiers.stats()
    demoted = st["host_blocks_used"] + st["spill_blocks_used"]
    plen = (eng.max_blocks - 1) * BS
    for j in range(eng.num_blocks // (eng.max_blocks - 1) + 1):
        _jserve(eng, f"junk{j}",
                [(30 + j * plen + i) % 231 + 25 for i in range(plen)], 1)
    resident = eng.resident_prefix_blocks(PROMPT)
    ctx = tracer.start_request("serve-request")
    tokens = _jserve(eng, "r", PROMPT, 6, trace=ctx)
    tracer.finish_request(ctx)
    fetch = [s["attrs"]["blocks"] for s in tracer.export(ctx.trace_id)
             if s["name"] == "tier-fetch"]
    stats = [eng.stats[k] for k in worker.TIER_KEYS]
    export = eng.export_kv_blocks(PROMPT)
    counts = eng.import_kv_blocks(IMPORT_PROMPT, import_blocks)
    return {"demoted": demoted, "resident": resident, "tokens": tokens,
            "fetch": fetch, "stats": stats, "export": export,
            "imported": [counts["imported"], counts["skipped"]],
            "import_tokens": _jserve(eng, "d", IMPORT_PROMPT, 6),
            "import_hits": eng.stats["prefix_hit_tokens"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = jllama.init_params(CFG, jax.random.PRNGKey(0))
    src = _jengine(params)
    _jserve(src, "s", IMPORT_PROMPT, 1)
    jax_export = src.export_kv_blocks(IMPORT_PROMPT)
    cold = {name: _jserve(_jengine(params), "c", p, 6)
            for name, p in (("prompt", PROMPT), ("import", IMPORT_PROMPT))}
    task = {"variants": VARIANTS, "prompt": PROMPT,
            "import_prompt": IMPORT_PROMPT, "jax_export": jax_export,
            "max_slots": SLOTS, "max_len": MAX_LEN, "block_size": BS}
    collect = worker.spawn(
        task, {f"llama_tiny/{k}": v for k, v in _flat(params).items()},
        tmp_path_factory.mktemp("tp_tiers"), wait=False)
    want = {v["name"]: _jax_resume(params, v, jax_export) for v in VARIANTS}
    return {"params": params, "outs": collect(), "jax": want, "cold": cold}


def _shape():
    return (CFG.n_layers, CFG.n_kv_heads, BS, CFG.head_dim)


@pytest.mark.parametrize("name", NAMES)
def test_resumes_from_the_tiers_like_jax(runs, name):
    out, want = runs["outs"][0], runs["jax"][name]
    assert int(out[f"{name}_demoted"]) == want["demoted"] >= 3
    assert int(out[f"{name}_resident_after_fill"]) == want["resident"] == 0
    assert out[f"{name}_tokens"].tolist() == want["tokens"] == \
        runs["cold"]["prompt"]
    assert out[f"{name}_fetch"].tolist() == want["fetch"]
    assert want["fetch"][0] >= 2
    stats = dict(zip(worker.TIER_KEYS, out[f"{name}_stats"].tolist()))
    assert stats == dict(zip(worker.TIER_KEYS, want["stats"]))
    assert stats["tier_fetch_blocks"] >= 2
    assert stats["prefix_hit_tokens"] >= 2 * BS


def test_the_spill_tier_serves_the_tp2_resume(runs):
    stats = dict(zip(worker.TIER_KEYS, runs["outs"][0]["tp2_stats"]))
    assert stats["spill_blocks_total"] == 48
    assert stats["tier_hits_spill"] >= 1


@pytest.mark.parametrize("name", NAMES)
def test_export_equals_jaxs(runs, name):
    out = runs["outs"][0]
    want = worker.payloads(runs["jax"][name]["export"], _shape())
    assert out[f"{name}_export_index"].tolist() == want[1].tolist() == \
        [0, 1, 2]
    assert out[f"{name}_export_hash"].tolist() == want[2].tolist()
    np.testing.assert_allclose(out[f"{name}_export_kv"], want[0], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_imports_a_jax_export_and_serves_its_cold_tokens(runs, name):
    out, want = runs["outs"][0], runs["jax"][name]
    assert out[f"{name}_imported"].tolist() == want["imported"] == [3, 0]
    assert out[f"{name}_import_tokens"].tolist() == want["import_tokens"] \
        == runs["cold"]["import"]
    assert int(out[f"{name}_import_hits"]) == want["import_hits"]


def _records(out, name):
    return [{"index": int(i), "hash": int(h),
             "k": base64.b64encode(kv[0].astype("<f4").tobytes()).decode(),
             "v": base64.b64encode(kv[1].astype("<f4").tobytes()).decode()}
            for i, h, kv in zip(out[f"{name}_export_index"],
                                out[f"{name}_export_hash"],
                                out[f"{name}_export_kv"])]


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_group_export_imports_into_a_one_process_replica(runs, package):
    blocks = _records(runs["outs"][0], "tp2")
    if package == "torch":
        params = params_from_jax(TCFG, jax.tree.map(np.asarray,
                                                    runs["params"]), "cpu")
        dst = PagedServeEngine(TCFG, params, max_slots=SLOTS,
                               max_len=MAX_LEN, block_size=BS, device="cpu")
        req = Request
    else:
        dst, req = _jengine(runs["params"]), JRequest
    assert dst.import_kv_blocks(PROMPT, blocks) == \
        {"imported": 3, "skipped": 0}
    dst.add_request(req("d", PROMPT, max_new_tokens=6))
    assert dst.run()[0].tokens == runs["cold"]["prompt"]
    assert dst.stats["prefix_hit_tokens"] == 2 * BS


@pytest.mark.parametrize("name", NAMES)
def test_followers_replay_every_plan_and_hold_no_tiers(runs, name):
    var = next(v for v in VARIANTS if v["name"] == name)
    sent = runs["outs"][0][f"{name}_sent"].tolist()
    assert sent[tmh.OP_READ_BLOCKS] >= 2 and sent[tmh.OP_WRITE_BLOCKS] >= 2
    assert sent[tmh.OP_STOP] == 1
    for r in range(1, var["tp"]):
        out = runs["outs"][r]
        assert int(out[f"{name}_replayed"]) == sum(sent) - 1
        assert not bool(out[f"{name}_follower_tiers"])


@pytest.mark.gpu
def test_serve_tp_tiers_phase_on_card():
    """``chip_smoke.py``'s ``serve_tp_tiers`` phase: two ranks at ``--tp 2
    --paged --host-blocks`` sharing the card, llama3_8b at full width and
    depth."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import subprocess
    import chip_smoke
    from kuberay_tpu_torch.ops import _build
    _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = tllama.CONFIGS["llama3_8b"]
    params = tllama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    run = chip_smoke.serve_tp_tiers(cfg, params, smi)
    assert run["block_plans"]["read"] > 0 and run["block_plans"]["write"] > 0


def test_tp_gaps_tool_needs_a_card(monkeypatch):
    """``tools/tp_gaps.py`` (the tp group's recompute gaps over prompt
    sets and arrival orders) runs only on the card."""
    from kuberay_tpu_torch.tools import tp_gaps
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tp_gaps.main([])
