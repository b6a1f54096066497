"""The plain reference against the port's plain (CPU) paths, at tiny
sizes, on the same weights."""

import dataclasses

import pytest
import torch

from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.train import train_step as ts
from portbench import check
from portbench.counts import Dims
from portbench.reference import llama as ref
from portbench.weights import leaf_names, make_params

DIMS = Dims(vocab=97, d=64, layers=2, heads=4, kv_heads=2, head_dim=16,
            ff=96, tied=False)
EPS, THETA = 1e-5, 10000.0


def _cfg(dims, **kw):
    return llama.LlamaConfig(
        vocab_size=dims.vocab, d_model=dims.d, n_layers=dims.layers,
        n_heads=dims.heads, n_kv_heads=dims.kv_heads, d_ff=dims.ff,
        max_seq_len=64, rope_theta=THETA, norm_eps=EPS,
        tie_embeddings=dims.tied, dtype=torch.float32, attn_impl="xla",
        remat=False, **kw)


@pytest.mark.parametrize("tied", [False, True])
def test_logits_match_the_ports_forward(tied):
    dims = dataclasses.replace(DIMS, tied=tied)
    params = make_params(dims, 5, "cpu", torch.float32)
    tokens = torch.randint(0, dims.vocab, (1, 23),
                           generator=torch.Generator().manual_seed(0))
    port = llama.forward(_cfg(dims), params, tokens)[0]
    rows = list(range(23))
    mine = ref.logits_at(params, dims, EPS, THETA, tokens[0].tolist(), rows)
    torch.testing.assert_close(mine, port, rtol=1e-4, atol=1e-4)
    gaps = check.served_gaps(mine, port.argmax(-1).tolist())
    assert max(gaps) == 0.0


def test_training_steps_match_the_ports_step():
    dims = dataclasses.replace(DIMS, tied=True)
    cfg = _cfg(dims, xent_chunk=0)
    tc = ts.TrainConfig(learning_rate=1e-2, warmup_steps=2, decay_steps=50,
                        param_dtype="float32", mu_dtype="float32")
    opt = ts.make_optimizer(tc)
    step = ts.make_train_step(cfg, tc, opt)
    params = make_params(dims, 9, "cpu", torch.float32)
    state = {"step": 0, "params": params, "opt_state": opt.init(params)}
    data = torch.randint(0, dims.vocab, (3, 2, 17),
                         generator=torch.Generator().manual_seed(1))
    losses = []
    for k in range(3):
        state, m = step(state, {"tokens": data[k, :, :-1],
                                "targets": data[k, :, 1:]})
        losses.append(float(m["total_loss"]))
        if k == 0:
            mu = state["opt_state"]["mu"]
            grad1 = {n: float(_leaf(mu, n).norm()) / (1 - tc.beta1)
                     for n in leaf_names(dims)}
    p0 = make_params(dims, 9, "cpu", torch.float32)
    change = {n: float((_leaf(state["params"], n) - _leaf(p0, n)).norm())
              for n in leaf_names(dims)}
    mine = ref.train(p0, dims, EPS, THETA, list(data),
                     ref.Optim(1e-2, 2, 50, tc.weight_decay, tc.beta1,
                               tc.beta2, tc.grad_clip), tc.z_loss)
    got = check.train_numbers({"losses": losses, "grad1": grad1,
                               "change": change}, mine)
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-4
    assert got["change_gap"] < 1e-3
    assert mine["change"]["embed"] > 0


def _leaf(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return tree


def test_lower_precision_moves_the_logits():
    params = make_params(DIMS, 3, "cpu", torch.float32)
    toks = list(range(1, 30))
    a = ref.logits_at(params, DIMS, EPS, THETA, toks, range(29))
    b = ref.logits_at(params, DIMS, EPS, THETA, toks, range(29),
                      ref.Lowp("fp8"))
    c = ref.logits_at(params, DIMS, EPS, THETA, toks, range(29),
                      ref.Lowp("int8w"))
    assert 0 < float((a - c).abs().max()) < float((a - b).abs().max())
