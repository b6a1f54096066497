"""Training data: batches of token windows from a uint32 token shard.

Port of ``kuberay_tpu/train/data.py``'s NumPy path (``TokenShardLoader``
with ``_splitmix64`` shuffling, ``write_token_shard``,
``synthetic_shard``): the same seed gives the same batches.  The JAX
package's native C++ prefetching loader is not ported yet (ROADMAP C7), so
``backend`` is always ``"numpy"``.  Shards are flat little-endian uint32
files.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class TokenShardLoader:
    """Iterates {"tokens", "targets"} int32 batches [batch, seq_len] from a
    token shard: window i holds tokens [i * (seq_len + 1), (i + 1) *
    (seq_len + 1)), targets are tokens shifted by one.  With ``shuffle``
    the window order within each epoch is a splitmix64 hash of (seed,
    epoch), a pure function of the seed."""

    def __init__(self, path: str, seq_len: int, batch: int, seed: int = 0,
                 shuffle: bool = True):
        self.path = str(path)
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.shuffle = shuffle
        self._tokens = np.memmap(self.path, dtype=np.uint32, mode="r")
        self._n_windows = len(self._tokens) // (seq_len + 1)
        if self._n_windows < 1:
            raise ValueError(f"shard {path} smaller than one window "
                             f"({seq_len + 1} tokens)")
        self._cursor = 0

    @property
    def backend(self) -> str:
        return "numpy"

    @property
    def num_windows(self) -> int:
        return self._n_windows

    @staticmethod
    def _splitmix64(x) -> np.uint64:
        with np.errstate(over="ignore"):
            x = np.uint64(x) + np.uint64(0x9E3779B97F4A7C15)
            x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            return x ^ (x >> np.uint64(31))

    def _numpy_batch(self) -> np.ndarray:
        win = self.seq_len + 1
        out = np.empty((self.batch, win), dtype=np.uint32)
        for r in range(self.batch):
            i = self._cursor
            self._cursor += 1
            epoch, within = divmod(i, self._n_windows)
            if self.shuffle:
                h = self._splitmix64(np.uint64(within) ^ self._splitmix64(
                    np.uint64(self.seed + epoch)))
                within = int(h % np.uint64(self._n_windows))
            out[r] = self._tokens[within * win:(within + 1) * win]
        return out

    def next(self) -> Dict[str, np.ndarray]:
        raw = self._numpy_batch()
        return {"tokens": raw[:, :-1].astype(np.int32),
                "targets": raw[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    def close(self):
        """Release the shard's memory map."""
        self._tokens = None


def write_token_shard(path: str, tokens: np.ndarray) -> None:
    """Write a uint32 token shard (the on-disk format)."""
    np.asarray(tokens, dtype=np.uint32).tofile(path)


def synthetic_shard(path: str, n_tokens: int, vocab: int, seed: int = 0):
    """``n_tokens`` uniform token ids below ``vocab`` from numpy's
    ``default_rng(seed)``, written as a shard."""
    rng = np.random.default_rng(seed)
    write_token_shard(path, rng.integers(0, vocab, n_tokens, dtype=np.uint32))
