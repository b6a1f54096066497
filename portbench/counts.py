"""Operations and bytes from shapes, the chip's published peaks, and MFU.

Bases:

- Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
  700 W): 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in float32
  outside them, 3.35 TB/s of HBM3.  Keyed by a substring of
  ``torch.cuda.get_device_name()``; a card the table lacks gives no share.
- Training MFU: (6 N + 12 L d S) FLOPs a trained token (the JAX bench's
  and the port's ``bench.py`` count): N counts every parameter once (a
  tied embedding once), 12 L d S is causal attention's score and value
  products forward and backward; remat's recompute is not counted.
- A serve forward's model FLOPs: 2 FLOPs a multiply-add of every matmul
  weight for each real token, the head's for each position whose logits
  are taken, and 4 * Hq * D FLOPs a layer for each (query, key) pair the
  causal mask leaves visible.  Padding rows and masked pairs are not
  counted.
- Bytes: each input byte read once and each output byte written once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

# name substring -> (bf16 TFLOP/s, float32 TFLOP/s, TB/s)
PEAKS = {
    "H100 80GB HBM3": (989.0, 67.0, 3.35),
}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    for key, (bf16, f32, tbs) in PEAKS.items():
        if key in device_name:
            return {"bf16_flops": bf16 * 1e12, "f32_flops": f32 * 1e12,
                    "bytes": tbs * 1e12}
    return None


@dataclasses.dataclass(frozen=True)
class Dims:
    """The shapes of a Llama-architecture decoder, from a config file."""
    vocab: int
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    tied: bool

    @classmethod
    def of(cls, config: Dict) -> "Dims":
        d, h = config["hidden_size"], config["num_attention_heads"]
        return cls(vocab=config["vocab_size"], d=d,
                   layers=config["num_hidden_layers"], heads=h,
                   kv_heads=config["num_key_value_heads"],
                   head_dim=config.get("head_dim") or d // h,
                   ff=config["intermediate_size"],
                   tied=bool(config["tie_word_embeddings"]))

    @property
    def layer_matmul_params(self) -> int:
        d, hd = self.d, self.head_dim
        q_out = self.heads * hd
        kv_out = self.kv_heads * hd
        return d * q_out + 2 * d * kv_out + q_out * d + 3 * d * self.ff

    @property
    def params(self) -> int:
        """Every parameter once (a tied embedding once)."""
        per_layer = self.layer_matmul_params + 2 * self.d
        head = 0 if self.tied else self.d * self.vocab
        return self.vocab * self.d + self.layers * per_layer + self.d + head

    @property
    def kv_bytes_per_token(self) -> int:
        """K and V of one position over every layer, bf16."""
        return 2 * self.layers * self.kv_heads * self.head_dim * 2


def train_flops_per_token(dims: Dims, seq: int) -> float:
    return 6.0 * dims.params + 12.0 * dims.layers * dims.d * seq


def visible_pairs(start: int, new: int) -> int:
    """(query, key) pairs a causal mask leaves visible for ``new`` queries
    at positions start .. start + new - 1."""
    return new * start + new * (new + 1) // 2


def forward_flops(dims: Dims, start: int, new: int, logits_rows: int) -> float:
    """Model FLOPs of one sequence's forward of ``new`` tokens after
    ``start`` cached ones, with logits at ``logits_rows`` positions."""
    linear = 2.0 * dims.layers * dims.layer_matmul_params * new
    attn = 4.0 * dims.layers * dims.heads * dims.head_dim * \
        visible_pairs(start, new)
    return linear + attn + 2.0 * dims.d * dims.vocab * logits_rows


def weight_bytes(dims: Dims, rows: int, itemsize: int = 2) -> float:
    """Bytes of the weights one forward over ``rows`` token rows reads:
    every matmul weight and norm, the head, and the embedding rows the
    tokens pick."""
    per_layer = dims.layer_matmul_params + 2 * dims.d
    head = dims.d * dims.vocab
    return itemsize * (dims.layers * per_layer + dims.d + head
                       + rows * dims.d)


def decode_step_bound_s(dims: Dims, contexts: Iterable[int],
                        pk: Dict[str, float]) -> float:
    """The least time one decode step could take: its active slots'
    ``contexts`` (live positions each, the new one included); the larger
    of FLOPs at the bf16 peak and bytes (weights once, live KV once, the
    new KV written) at the HBM peak."""
    ctx = list(contexts)
    flops = sum(forward_flops(dims, c - 1, 1, 1) for c in ctx)
    kv = dims.kv_bytes_per_token
    nbytes = weight_bytes(dims, len(ctx)) + kv * sum(ctx) + kv * len(ctx)
    return max(flops / pk["bf16_flops"], nbytes / pk["bytes"])


def paged_decode_bound_s(dims: Dims, contexts: Iterable[int],
                         block_size: int, pk: Dict[str, float]) -> float:
    """One layer's paged decode-attention call over every row it is given
    (``contexts``: live positions each): each live K/V row and table entry
    read once, q read and out written once (bf16)."""
    ctx = list(contexts)
    hd, hq, hkv = dims.head_dim, dims.heads, dims.kv_heads
    kv_rows = 2 * hkv * hd * 2 * sum(ctx)
    tables = 4 * sum(-(-c // block_size) for c in ctx)
    qo = 2 * 2 * hq * hd * len(ctx)
    flops = 4.0 * hq * hd * sum(ctx)
    return max(flops / pk["bf16_flops"],
               (kv_rows + tables + qo) / pk["bytes"])


# FLOPs a visible (q, k) pair and head, per kernel of the flash trio.
FLASH_FLOPS_PER_PAIR = {"fwd": 4, "bwd_dkv": 8, "bwd_dq": 6}


def flash_bound_s(kind: str, batch: int, seq: int, heads: int,
                  kv_heads: int, head_dim: int, pk: Dict[str, float]) -> float:
    """One causal flash launch over [batch, seq, heads, head_dim] bf16: its
    visible pairs' FLOPs at the bf16 peak, or its operands read and
    results written once at the HBM peak (q, k, v, out or dout, the
    float32 log-sum-exp and delta rows), whichever is larger."""
    pairs = batch * heads * visible_pairs(0, seq)
    flops = FLASH_FLOPS_PER_PAIR[kind] * head_dim * pairs
    q = batch * seq * heads * head_dim * 2
    kv = batch * seq * kv_heads * head_dim * 2
    rows = batch * heads * seq * 4
    nbytes = {"fwd": 2 * q + 2 * kv + rows,
              "bwd_dkv": 2 * q + 4 * kv + 2 * rows,
              "bwd_dq": 3 * q + 2 * kv + 2 * rows}[kind]
    return max(flops / pk["bf16_flops"], nbytes / pk["bytes"])
