"""The Llama family: decoders whose equations are Llama's (RMSNorm,
half-split RoPE, grouped-query attention, SwiGLU), run through the port's
``models/llama.py`` and checked against ``reference/llama.py``.

A configuration of this family gives its published keys; a key that would
make its equations differ from Llama's (an activation other than SiLU, a
sliding window, RoPE scaling) is refused rather than run as something
else.  ``torch_dtype`` is the serving weights' and the compute dtype; a
training configuration's ``train`` group gives the master weights' and
Adam moments' dtypes, the remat policy and the cross-entropy chunk.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from portbench import weights
from portbench.counts import Dims
from portbench.reference import llama as reference

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}

Lowp = reference.Lowp


def dims(config: Dict) -> Dims:
    if config.get("hidden_act", "silu") != "silu" or \
            config.get("sliding_window") is not None or \
            config.get("rope_scaling") is not None:
        raise ValueError(f"{config['name']}: its equations are not "
                         f"Llama's (activation, sliding window or RoPE "
                         f"scaling)")
    return Dims.of(config)


def dtype(config: Dict) -> torch.dtype:
    return DTYPES[config["torch_dtype"]]


def port_config(config: Dict, train: Optional[Dict] = None):
    """The port's ``LlamaConfig``: for serving, or with ``train`` (the
    configuration's ``train`` group) for the train step."""
    from kuberay_tpu_torch.models.llama import LlamaConfig

    d = dims(config)
    kw = {}
    if train is not None:
        remat = train["remat"]
        kw = dict(remat=remat != "none",
                  remat_policy=remat if remat != "none" else "full",
                  xent_chunk=train["xent_chunk"])
    return LlamaConfig(
        vocab_size=d.vocab, d_model=d.d, n_layers=d.layers, n_heads=d.heads,
        n_kv_heads=d.kv_heads, d_ff=d.ff,
        max_seq_len=config["max_position_embeddings"],
        rope_theta=float(config["rope_theta"]),
        norm_eps=config["rms_norm_eps"], tie_embeddings=d.tied,
        dtype=dtype(config), **kw)


def make_params(config: Dict, seed: int, device, dt: torch.dtype) -> Dict:
    return weights.make_params(dims(config), seed, device, dt)


def leaf_names(config: Dict) -> List[str]:
    return weights.leaf_names(dims(config))


def make_leaf(config: Dict, seed: int, name: str, device,
              dt: torch.dtype) -> torch.Tensor:
    return weights.make_leaf(dims(config), seed,
                             leaf_names(config).index(name), device, dt)


get_leaf = weights.get_leaf


def reference_logits(params: Dict, config: Dict, tokens: Sequence[int],
                     rows: Sequence[int], lowp=None) -> torch.Tensor:
    return reference.logits_at(
        params, dims(config), config["rms_norm_eps"],
        float(config["rope_theta"]), tokens, rows, lowp or reference.F32)


def reference_train(params: Dict, config: Dict,
                    batches: Sequence[torch.Tensor], lowp=None,
                    rows: Optional[slice] = None) -> Dict:
    tr = config["train"]
    return reference.train(
        params, dims(config), config["rms_norm_eps"],
        float(config["rope_theta"]), batches,
        reference.Optim(tr["learning_rate"], tr["warmup_steps"],
                        tr["decay_steps"], tr["weight_decay"], tr["beta1"],
                        tr["beta2"], tr["grad_clip"]),
        tr["z_loss"], lowp or reference.F32, rows)
