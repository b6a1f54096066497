"""Training batches made on the card.

Parameters: ``batch`` rows of ``seq_len + 1`` uniform token ids a batch,
``pool`` batches, drawn on the given device from the seed in one call; a
row's tokens are its first ``seq_len`` ids and its targets the last
``seq_len``.
"""

from __future__ import annotations

from typing import Dict

KEYS = ("batch", "seq_len", "pool")


def batches(mix: Dict, vocab: int, seed: int, device, count: int = 0):
    """``[count or pool, batch, seq_len + 1]`` int64 token ids on
    ``device``."""
    import torch

    n = count or int(mix["pool"])
    g = torch.Generator(device=device)
    g.manual_seed(abs(int(seed)) % (2 ** 63))
    return torch.randint(0, vocab, (n, mix["batch"], mix["seq_len"] + 1),
                         generator=g, device=device)
