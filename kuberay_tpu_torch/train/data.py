"""Training data: batches of token windows from a uint32 token shard.

Port of ``kuberay_tpu/train/data.py``: the native C++ prefetching loader
(``native/dataloader.cpp``, a copy of the JAX package's: it mmaps the
shard and slices batches on C++ threads), with the NumPy path for a host
without a C++ compiler, and ``write_token_shard`` / ``synthetic_shard``.
The same seed gives the same batches on either path.  Shards are flat
little-endian uint32 files.

The native library is compiled with the host C++ compiler at first use
into ``kuberay_tpu_torch/_build/libdataloader-<hash>.so``, keyed on the
source's sha256, and published with an atomic rename.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterator, Optional

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "dataloader.cpp"
_BUILD = _PKG / "_build"
_lock = threading.Lock()
_native_lib: Optional[ctypes.CDLL] = None
_native_tried = False


def build_native() -> Optional[pathlib.Path]:
    """Compile ``native/dataloader.cpp`` once per source hash; returns the
    library's path, or None when the host has no C++ compiler.  A compile
    error raises."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    src = _SRC.read_bytes()
    so = _BUILD / f"libdataloader-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    # A builder-private temporary name, then an atomic rename: concurrent
    # builders each publish a whole library.
    fd, tmp = tempfile.mkstemp(dir=_BUILD, prefix=f".{so.name}.")
    os.close(fd)
    try:
        done = subprocess.run([cxx, "-O3", "-std=c++17", "-shared", "-fPIC",
                               "-pthread", str(_SRC), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if done.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {_SRC}:\n{done.stderr}")
        os.replace(tmp, so)
    finally:
        pathlib.Path(tmp).unlink(missing_ok=True)
    return so


def _load_native() -> Optional[ctypes.CDLL]:
    so = build_native()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.dl_open.restype = ctypes.c_void_p
    lib.dl_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
    lib.dl_next.restype = ctypes.c_int
    lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32)]
    lib.dl_num_windows.restype = ctypes.c_int64
    lib.dl_num_windows.argtypes = [ctypes.c_void_p]
    lib.dl_num_tokens.restype = ctypes.c_int64
    lib.dl_num_tokens.argtypes = [ctypes.c_void_p]
    lib.dl_close.restype = None
    lib.dl_close.argtypes = [ctypes.c_void_p]
    return lib


def native_library() -> Optional[ctypes.CDLL]:
    """The native loader's library, built and loaded on first call; None
    without a C++ compiler."""
    global _native_lib, _native_tried
    with _lock:
        if not _native_tried:
            _native_lib = _load_native()
            _native_tried = True
    return _native_lib


class TokenShardLoader:
    """Iterates {"tokens", "targets"} int32 batches [batch, seq_len] from a
    token shard: window i holds tokens [i * (seq_len + 1), (i + 1) *
    (seq_len + 1)), targets are tokens shifted by one.  With ``shuffle``
    the window order within each epoch is a splitmix64 hash of (seed,
    epoch), a pure function of the seed.

    ``prefer_native`` reads through the native loader when the host can
    build it (``backend`` says which ran).  ``n_threads=1`` keeps its
    batch order the NumPy path's; more threads prefetch faster and draw
    rows from a shared cursor in racy order."""

    def __init__(self, path: str, seq_len: int, batch: int, seed: int = 0,
                 shuffle: bool = True, prefer_native: bool = True,
                 n_threads: int = 1):
        self.path = str(path)
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.shuffle = shuffle
        self._handle = None
        self._lib = native_library() if prefer_native else None
        if self._lib is not None:
            self._handle = self._lib.dl_open(
                self.path.encode(), seq_len, batch, ctypes.c_uint64(seed),
                int(shuffle), n_threads)
            if self._handle:
                return
            # A shard it cannot open: the NumPy path says why.
            self._lib = None
        self._tokens = np.memmap(self.path, dtype=np.uint32, mode="r")
        self._n_windows = len(self._tokens) // (seq_len + 1)
        if self._n_windows < 1:
            raise ValueError(f"shard {path} smaller than one window "
                             f"({seq_len + 1} tokens)")
        self._cursor = 0

    @property
    def backend(self) -> str:
        return "native" if self._lib is not None else "numpy"

    @property
    def num_windows(self) -> int:
        if self._lib is not None:
            return int(self._lib.dl_num_windows(self._handle))
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

    def _native_batch(self) -> np.ndarray:
        if not self._handle:
            raise RuntimeError("native loader is closed")
        out = np.empty((self.batch, self.seq_len + 1), dtype=np.uint32)
        rc = self._lib.dl_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        if rc != 0:
            raise RuntimeError("native loader shut down")
        return out

    def next(self) -> Dict[str, np.ndarray]:
        raw = (self._native_batch() if self._lib is not None
               else self._numpy_batch())
        return {"tokens": raw[:, :-1].astype(np.int32),
                "targets": raw[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    def close(self):
        """Stop the native loader's threads, or release the memory map."""
        if self._handle:
            self._lib.dl_close(self._handle)
            self._handle = None
        self._tokens = None

    def __del__(self):
        self.close()


def write_token_shard(path: str, tokens: np.ndarray) -> None:
    """Write a uint32 token shard (the on-disk format)."""
    np.asarray(tokens, dtype=np.uint32).tofile(path)


def synthetic_shard(path: str, n_tokens: int, vocab: int, seed: int = 0):
    """``n_tokens`` uniform token ids below ``vocab`` from numpy's
    ``default_rng(seed)``, written as a shard."""
    rng = np.random.default_rng(seed)
    write_token_shard(path, rng.integers(0, vocab, n_tokens, dtype=np.uint32))
