"""PyTorch port, tensor-parallel serving vs the JAX package.

One spawn of 4 gloo ranks (``torch_tp_serve_worker.py``, started once
for the module while JAX computes its side on the 8 virtual CPU devices)
runs every variant at ``llama_tiny`` / ``mixtral_tiny`` (float32) from the
JAX package's seed-0 params:

- ``tp_factors``, ``validate_tp`` and ``serve_mesh`` against JAX's, error
  texts included; each rank's mesh coordinate against the device JAX's
  ``serve_mesh`` puts there;
- each param, dense-cache and paged-pool leaf's chunk on the tp=2 and
  tp=4 (tp=2 x tpr=2) meshes against JAX's ``NamedSharding``
  (``devices_indices_map``), bf16 and int8 layouts; ``init_sharded_params``
  against the seeded whole tree sliced, Llama and Mixtral;
- one prefill and one decode step of ``forward_with_cache`` at tp=2: the
  gathered logits within 1e-5 of JAX's ``forward_with_cache``;
- int8 weights at tp=2: each rank's scales equal its slice of JAX's
  ``quantize_weights`` to 1e-6 relative (``wo``'s and ``w_down``'s maxima
  all-reduced over the split contraction axis);
- greedy tokens of the port's lockstep engines (rank 0 a
  ``MultihostServeEngine``, the others ``follower_loop``) at tp=2 for
  dense, int8 KV, chunked prefill plus speculation, paged, paged int8,
  int8 weights and Mixtral, and at tp=4 (tpr=2): identical to JAX's
  engine on ``serve_mesh`` and to the port's tp=1 engine, on
  ``tests/test_tp_serving.py``'s prompts (and one sharing three blocks
  with another, for the paged prefix cache); every follower replays each
  device call of rank 0; each rank's cache holds its kv heads;
- under tp > 1 the bf16 paged engine takes the KV tiers and block export
  and import (``test_torch_tp_tiers.py`` runs them), and the int8 pool
  refuses them with the JAX engine's texts.

The JAX engines run their decode on the XLA path (``decode_impl="xla"``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.models import mixtral as jmixtral
from kuberay_tpu.serve import kv_cache as jkv
from kuberay_tpu.serve import sharding as jsh
from kuberay_tpu.serve.engine import Request as JRequest
from kuberay_tpu.serve.engine import ServeEngine as JServeEngine
from kuberay_tpu.serve.paged_engine import PagedServeEngine as JPagedEngine
from kuberay_tpu.serve.weight_quant import quantize_weights as jquantize
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models import mixtral as tmixtral
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.serve import sharding as tsh
from kuberay_tpu_torch.serve.engine import Request, ServeEngine
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine

import torch_tp_serve_worker

torch.set_num_threads(2)

CFG = jllama.CONFIGS["llama_tiny"]
MCFG = jmixtral.CONFIGS["mixtral_tiny"]
TCFGS = {"llama_tiny": tllama.CONFIGS["llama_tiny"],
         "mixtral_tiny": tmixtral.CONFIGS["mixtral_tiny"]}
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [20] * 10, list(range(30)),
           list(range(24)) + [9, 9, 9]]
SLOTS, MAX_LEN, MAX_NEW, BS = 4, 128, 12, 8
WORLD = 4
VARIANTS = [
    {"name": "dense", "tp": 2, "model": "llama_tiny"},
    {"name": "kv_int8", "tp": 2, "model": "llama_tiny",
     "kw": {"kv_quant": "int8"}},
    {"name": "chunk_spec", "tp": 2, "model": "llama_tiny",
     "kw": {"prefill_chunk": 16, "speculative": 4}},
    {"name": "paged", "tp": 2, "model": "llama_tiny", "paged": True,
     "kw": {"block_size": BS}},
    {"name": "paged_int8", "tp": 2, "model": "llama_tiny", "paged": True,
     "kw": {"block_size": BS, "kv_quant": "int8"}},
    {"name": "weight_int8", "tp": 2, "model": "llama_tiny",
     "kw": {"weight_quant": "int8"}},
    {"name": "mixtral", "tp": 2, "model": "mixtral_tiny"},
    {"name": "tp4_tpr2", "tp": 4, "model": "llama_tiny"},
]
NAMES = [v["name"] for v in VARIANTS]
# The forward's inputs: 4 rows of 12 tokens, then one token a row.
FWD_S, FWD_T = 4, 12


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, dtype=np.float32)}


def _jax_tokens(cfg, params, var):
    mesh = jsh.serve_mesh(var["tp"], n_kv_heads=cfg.n_kv_heads)
    cls = JPagedEngine if var.get("paged") else JServeEngine
    eng = cls(cfg, params, max_slots=SLOTS, max_len=MAX_LEN, mesh=mesh,
              decode_impl="xla", **var.get("kw", {}))
    for i, p in enumerate(PROMPTS):
        eng.add_request(JRequest(f"r{i}", p, max_new_tokens=MAX_NEW))
    got = {r.request_id: r.tokens for r in eng.run()}
    return [got[f"r{i}"] for i in range(len(PROMPTS))]


def _port_tp1_tokens(cfg, np_params, var):
    tcfg = TCFGS[var["model"]]
    params = params_from_jax(tcfg, np_params, "cpu")
    cls = PagedServeEngine if var.get("paged") else ServeEngine
    eng = cls(tcfg, params, max_slots=SLOTS, max_len=MAX_LEN, device="cpu",
              **var.get("kw", {}))
    for i, p in enumerate(PROMPTS):
        eng.add_request(Request(f"r{i}", p, max_new_tokens=MAX_NEW))
    got = {r.request_id: r.tokens for r in eng.run()}
    return [got[f"r{i}"] for i in range(len(PROMPTS))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = jllama.init_params(CFG, jax.random.PRNGKey(0))
    mparams = jmixtral.init_params(MCFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    arrays = {f"llama_tiny/{k}": v for k, v in _flat(params).items()}
    arrays.update({f"mixtral_tiny/{k}": v
                   for k, v in _flat(mparams).items()})
    arrays["fwd_tokens"] = rng.integers(0, CFG.vocab_size, (FWD_S, FWD_T)
                                        ).astype(np.int32)
    arrays["fwd_next"] = rng.integers(0, CFG.vocab_size, FWD_S
                                      ).astype(np.int32)
    arrays["fwd_lens"] = np.full(FWD_S, FWD_T, np.int32)
    task = {"variants": VARIANTS, "prompts": PROMPTS, "max_slots": SLOTS,
            "max_len": MAX_LEN, "max_new": MAX_NEW}
    collect = torch_tp_serve_worker.spawn(
        task, arrays, tmp_path_factory.mktemp("tp_serve"), world=WORLD,
        wait=False)
    trees = {"llama_tiny": (CFG, params), "mixtral_tiny": (MCFG, mparams)}
    jax_tokens, tp1_tokens = {}, {}
    for var in VARIANTS:
        cfg, p = trees[var["model"]]
        jax_tokens[var["name"]] = _jax_tokens(cfg, p, var)
        tp1_tokens[var["name"]] = _port_tp1_tokens(
            cfg, jax.tree.map(np.asarray, p), var)
    outs = collect()
    return {"params": params, "arrays": arrays, "outs": outs,
            "jax": jax_tokens, "tp1": tp1_tokens}


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("tp,n_kv", [(1, None), (2, None), (4, 8), (8, 8),
                                     (16, 8), (4, 2), (3, 2), (12, 8),
                                     (6, 4)])
def test_tp_factors_match_jax(tp, n_kv):
    assert _outcome(tsh.tp_factors, tp, n_kv) == \
        _outcome(jsh.tp_factors, tp, n_kv)


def _cfg(**kw):
    return dataclasses.replace(CFG, **kw)


@pytest.mark.parametrize("cfg_kw,tp,n_kv", [
    ({}, 2, 2), ({}, 4, 2), ({}, 4, None), ({}, 8, 2),
    ({"n_heads": 6, "n_kv_heads": 3}, 2, 3),
    ({"d_ff": 130}, 4, 2), ({"vocab_size": 250}, 4, 2),
    ({"n_heads": 8, "n_kv_heads": 4}, 4, 4),
])
def test_validate_tp_matches_jax(cfg_kw, tp, n_kv):
    """The same verdict and text for a mesh of ``tp`` over ``n_kv`` kv
    heads (the port's check reads the mesh's axis sizes)."""
    cfg = _cfg(**cfg_kw)
    kv, rep = jsh.tp_factors(tp, n_kv)
    jmesh = jsh.serve_mesh(tp, n_kv_heads=n_kv)
    assert dict(jmesh.shape) == {"tp": kv, "tpr": rep}
    assert _outcome(tsh.validate_tp, cfg, {"tp": kv, "tpr": rep}) == \
        _outcome(jsh.validate_tp, cfg, jmesh)
    assert tsh.mesh_tp({"tp": kv, "tpr": rep}) == jsh.mesh_tp(jmesh)


def test_serve_mesh_refuses_more_tp_than_processes_as_jax_does(tmp_path):
    """A group of one: ``serve_mesh(2)`` gives JAX's text for one device;
    ``serve_mesh(1)`` is the (1, 1) mesh."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        ours = _outcome(tsh.serve_mesh, 2, None, "cpu")
        mesh = tsh.serve_mesh(1, 8, "cpu")
        lay = tsh.serve_layout(mesh)
        assert (lay.size("tp"), lay.size("tpr")) == (1, 1)
    finally:
        dist.destroy_process_group()
    ref = _outcome(jsh.serve_mesh, 2, jax.devices()[:1])
    assert ours == ref == ("error", "tp=2 needs 2 devices, have 1")


@pytest.mark.parametrize("tp", [2, 4])
def test_each_rank_sits_where_jax_puts_its_device(runs, tp):
    jmesh = jsh.serve_mesh(tp, n_kv_heads=CFG.n_kv_heads)
    for r in range(tp):
        i, j, kv, rep = runs["outs"][r][f"tp{tp}_coord"]
        assert (kv, rep) == (jmesh.shape["tp"], jmesh.shape["tpr"])
        assert jmesh.devices[i, j] == jax.devices()[r]


# ---------------------------------------------------------------------------
# where each leaf lives
# ---------------------------------------------------------------------------

def _jax_trees(tree: str, mesh, params):
    """(JAX shardings, global shapes) of one tree, flattened by path."""
    if tree == "params":
        sh = jsh.param_shardings(CFG, mesh)
        shapes = jax.tree.map(lambda a: a.shape, params)
    else:
        kind, quant = tree.split("_")
        if kind == "cache":
            sh = jsh.cache_shardings(CFG, mesh, quant)
            shapes = jax.tree.map(lambda a: a.shape, jkv.init_kv_cache(
                CFG, 4, 64, quant=quant))
        else:
            sh = jsh.paged_cache_shardings(mesh, quant)
            leaf = (CFG.n_layers, CFG.n_kv_heads, 128, CFG.head_dim)
            one = {"q": leaf, "s": leaf[:-1]} if quant == "int8" else leaf
            shapes = {"k": one, "v": one}
    flat_sh = {k: v for k, v in _paths(sh)}
    flat_shapes = {k: v for k, v in _paths(shapes)}
    return flat_sh, flat_shapes


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("tree", ["params", "cache_none", "cache_int8",
                                  "pool_none", "pool_int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_leaf_chunks_match_jax_named_sharding(runs, tp, tree):
    jmesh = jsh.serve_mesh(tp, n_kv_heads=CFG.n_kv_heads)
    sh, shapes = _jax_trees(tree, jmesh, runs["params"])
    assert sh
    for r in range(tp):
        dev = jax.devices()[r]
        out = runs["outs"][r]
        for path, s in sh.items():
            idx = s.devices_indices_map(tuple(shapes[path]))[dev]
            want = [[sl.start or 0 for sl in idx],
                    [(sl.stop if sl.stop is not None else n)
                     - (sl.start or 0)
                     for sl, n in zip(idx, shapes[path])]]
            got = out[f"tp{tp}_{tree}/{path}"]
            assert got.tolist() == want, (r, path)


@pytest.mark.parametrize("model", ["llama_tiny", "mixtral_tiny"])
@pytest.mark.parametrize("tp", [2, 4])
def test_init_sharded_params_is_the_seeded_tree_sliced(runs, tp, model):
    """Each rank's seeded shards equal its slice of ``init_params`` with
    the same seed, bit for bit (and contiguous)."""
    for r in range(tp):
        assert bool(runs["outs"][r][f"tp{tp}_init_equal_{model}"]), r


# ---------------------------------------------------------------------------
# the forward and the weight scales
# ---------------------------------------------------------------------------

def test_first_steps_gathered_logits_match_jax(runs):
    """The tp=2 forward's gathered logits (prefill of 4 rows, then one
    decode step) within 1e-5 of JAX's ``forward_with_cache``."""
    a = runs["arrays"]
    cache = jkv.init_kv_cache(CFG, FWD_S, 64)
    logits, cache = jkv.forward_with_cache(
        CFG, runs["params"], jnp.asarray(a["fwd_tokens"]), cache,
        jnp.zeros(FWD_S, jnp.int32))
    np.testing.assert_allclose(runs["outs"][0]["prefill_logits"],
                               np.asarray(logits), rtol=0, atol=1e-5)
    logits, _ = jkv.forward_with_cache(
        CFG, runs["params"], jnp.asarray(a["fwd_next"])[:, None], cache,
        jnp.asarray(a["fwd_lens"]))
    np.testing.assert_allclose(runs["outs"][0]["decode_logits"],
                               np.asarray(logits), rtol=0, atol=1e-5)


def test_int8_weight_scales_match_jax(runs):
    """Each rank's local scales are its slice of JAX's (whole-tree)
    scales: per output channel, over the whole contraction axis even
    where tp splits it (``wo``, ``w_down``)."""
    ref = {k: np.asarray(v) for k, v in _paths(jquantize(runs["params"]))}
    seen = 0
    for r in range(2):
        out = runs["outs"][r]
        for key in out:
            if not key.startswith("weight_int8_s8/"):
                continue
            path = key[len("weight_int8_s8/"):]
            want = ref[path]
            offs, sizes = out[f"tp2_params/{path[:-len('/s8')]}"]
            sl = tuple(slice(o, o + n) if d != want.ndim - 2 else slice(None)
                       for d, (o, n) in enumerate(zip(offs, sizes)))
            np.testing.assert_allclose(out[key], want[sl], rtol=1e-6, atol=0)
            seen += 1
    assert seen == 2 * 8          # wq wk wv wo w_gate w_up w_down lm_head


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_tp_engines_give_jax_tokens(runs, name):
    got = [runs["outs"][0][f"{name}_tokens_{i}"].tolist()
           for i in range(len(PROMPTS))]
    assert all(len(t) == MAX_NEW for t in got)
    assert got == runs["jax"][name]
    assert got == runs["tp1"][name]


@pytest.mark.parametrize("name", NAMES)
def test_followers_replay_every_device_call(runs, name):
    var = next(v for v in VARIANTS if v["name"] == name)
    calls = int(runs["outs"][0][f"{name}_calls"])
    assert calls > len(PROMPTS)
    cfg = TCFGS[var["model"]]
    kv = jsh.tp_factors(var["tp"], cfg.n_kv_heads)[0]
    for r in range(var["tp"]):
        out = runs["outs"][r]
        if r:
            assert int(out[f"{name}_replayed"]) == calls
        shapes = {k: v for k, v in out.items()
                  if k.startswith(f"{name}_cache/")}
        assert shapes
        for key, shape in shapes.items():
            # dense [L, S, M, Hkv, D], scales [L, S, Hkv, M]; pool [L,
            # Hkv, P(, D)]: the rank's kv heads only.
            head_dim = 1 if var.get("paged") else (
                2 if key.endswith("/s") else 3)
            assert shape[head_dim] == cfg.n_kv_heads // kv, key


def test_speculation_drafts_under_tp(runs):
    assert int(runs["outs"][0]["chunk_spec_drafted"]) > 0


def _jax_int8_refusal(what: str) -> str:
    """The JAX paged engine's text for an int8 pool's tiers, export or
    import."""
    kw = dict(max_slots=SLOTS, max_len=MAX_LEN, block_size=BS,
              kv_quant="int8", decode_impl="xla")
    params = jllama.init_params(CFG, jax.random.PRNGKey(0))
    try:
        if what == "tiers":
            JPagedEngine(CFG, params, host_blocks=8, **kw)
        else:
            eng = JPagedEngine(CFG, params, **kw)
            if what == "export":
                eng.export_kv_blocks(PROMPTS[3])
            else:
                eng.import_kv_blocks(PROMPTS[3], [])
    except (ValueError, NotImplementedError) as e:
        return str(e)
    raise AssertionError(f"the JAX int8 engine took {what}")


@pytest.mark.parametrize("what", ["tiers", "export", "import"])
def test_block_paths_are_refused_under_tp_naming_a9b(runs, what):
    """Under tp > 1 the bf16 pool takes the KV tiers and block export and
    import; the int8 pool refuses them with the JAX engine's texts (the
    ROADMAP A9b refusal of both pools is gone)."""
    want = _jax_int8_refusal(what)
    for r in range(2 if what == "tiers" else 1):
        assert str(runs["outs"][r][f"paged_{what}_refused"]) == ""
        assert str(runs["outs"][r][f"paged_int8_{what}_refused"]) == want
