"""PyTorch port, the persistent ring-attention kernel: its checks and its
schedule, on the CPU; the kernel against its plain version on a card.

- ``ring_attention_fwd``'s checks before launching, on meta tensors: each
  refusal raises and nothing launches.
- A CPU model of the kernel's persistent grid (``ring_schedule`` and
  ``ring_grid`` mirror ``csrc/ring_attention.cu``'s ``RingPlan`` and its
  grid): every (rank, batch, head, q tile) is taken exactly once; the
  tiles are handed out largest work first, and each block's own tiles
  come in falling work; the snake keeps the blocks' work within one
  tile's of each other; a tile reads exactly the K/V blocks (and tiles)
  that some row of it sees, in the ring's order; a waiting grid leaves
  SMs free, and the staged arrivals finish for any grid below the SM
  count even where each delivering copy needs an SM of its own (and do
  not at the SM count).
- On a card (``gpu`` marker; skips elsewhere): the kernel against its
  plain version over a LocalRing's stacked blocks and over an n-slot
  buffer filled on a side stream after the launch (bit for bit the
  in-place result).
"""

import numpy as np
import pytest
import torch

from kuberay_tpu_torch.ops import ring_attention as ra

torch.set_num_threads(2)


# --------------------------------------------------------------------------
# The wrapper's checks
# --------------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


Q = (4, 1, 256, 4, 64)              # R = 4 held ranks
KV = (4, 1, 256, 2, 64)             # n = 4 blocks
BAD = {
    "q_dims": (lambda: (_meta(1, 256, 4, 64), _meta(*KV), _meta(*KV), 0, 4,
                        None), "shapes"),
    "kv_mismatch": (lambda: (_meta(*Q), _meta(*KV), _meta(4, 1, 256, 1, 64),
                             0, 4, None), "shapes"),
    "ring_size": (lambda: (_meta(*Q), _meta(*KV), _meta(*KV), 0, 3, None),
                  "for a ring of 3"),
    "ranks_outside": (lambda: (_meta(*Q), _meta(*KV), _meta(*KV), 1, 4,
                               None), "outside a ring of 4"),
    "head_dim": (lambda: (_meta(4, 1, 256, 4, 32), _meta(4, 1, 256, 2, 32),
                          _meta(4, 1, 256, 2, 32), 0, 4, None),
                 "no kernel for head_dim 32"),
    "group": (lambda: (_meta(4, 1, 256, 6, 64), _meta(4, 1, 256, 2, 64),
                       _meta(4, 1, 256, 2, 64), 0, 4, None),
              "group 3"),
    "words": (lambda: (_meta(*Q), _meta(*KV), _meta(*KV), 0, 4,
                       _meta(3, dtype=torch.int32)), "words must be int32"),
    "device": (lambda: (_meta(*Q), _meta(*KV), _meta(*KV), 0, 4, None),
               "one CUDA device"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_fwd_wrapper_checks_before_launching(case):
    make, msg = BAD[case]
    q, k, v, rank0, n, words = make()
    launched = ra.launches
    with pytest.raises(ValueError, match=msg):
        ra.ring_attention_fwd(q, k, v, rank0, n, words=words)
    assert ra.launches == launched


def test_fwd_wrapper_refuses_other_dtypes():
    q, k = _meta(*Q, dtype=torch.float16), _meta(*KV, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        ra.ring_attention_fwd(q, k, k, 0, 4)


def test_arrive_on_the_cpu_stores_the_word():
    words = torch.zeros(4, dtype=torch.int32)
    ra.arrive(words, 2)
    assert words.tolist() == [0, 0, 1, 0]


# --------------------------------------------------------------------------
# The schedule
# --------------------------------------------------------------------------

# (R, rank0, n, B, Sl, Hq, causal, grid): the smoke's LocalRing(4) at
# B 2 x S 4096 on 132 SMs, one DeviceRing rank, a ragged shard, a ring of 8,
# non-causal, and grids that do not divide the tiles.
SCHED_CASES = {
    "smoke": (4, 0, 4, 2, 1024, 16, True, 132),
    "device_rank2": (1, 2, 4, 2, 1024, 16, True, 128),
    "ragged": (4, 0, 4, 1, 1000, 4, True, 7),
    "ring8": (8, 0, 8, 1, 384, 2, True, 13),
    "full": (4, 0, 4, 2, 512, 4, False, 11),
    "tiny_grid": (3, 0, 3, 1, 300, 2, True, 1),
}
BK = 128


def _tile_work(job, Sl, causal):
    """K/V tiles the job reads: per block, up to the last key its last row
    sees (the kernel's kv_tiles)."""
    last_row = min(job["q0"] + ra.BQ, Sl) - 1
    total = 0
    for _, off in job["blocks"]:
        end = min(Sl, max(0, last_row + off + 1)) if causal else Sl
        total += -(-end // BK)
    return total


def _schedule(case):
    R, rank0, n, B, Sl, Hq, causal, grid = SCHED_CASES[case]
    return ra.ring_schedule(R, rank0, n, B, Sl, Hq, causal, grid)


@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_schedule_takes_every_tile_once(case):
    R, rank0, n, B, Sl, Hq, causal, grid = SCHED_CASES[case]
    taken = [(j["j"], j["b"], j["h"], j["q0"])
             for jobs in _schedule(case) for j in jobs]
    want = {(j, b, h, q0) for j in range(R) for b in range(B)
            for h in range(Hq) for q0 in range(0, Sl, ra.BQ)}
    assert len(taken) == len(want) and set(taken) == want


@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_schedule_hands_out_the_largest_work_first(case):
    """The order the snake walks has falling work; each block's tiles come
    in falling work; blocks end within one largest tile's work of each
    other (the smoke: 1024 tiles, 16,896 tile-units on 132 blocks)."""
    R, rank0, n, B, Sl, Hq, causal, grid = SCHED_CASES[case]
    sched = _schedule(case)
    order = {}
    for c, jobs in enumerate(sched):
        works = [_tile_work(j, Sl, causal) for j in jobs]
        assert works == sorted(works, reverse=True), c
        for k, j in enumerate(jobs):
            idx = k * grid + (grid - 1 - c if k & 1 else c)
            order[idx] = works[k]
    seq = [order[i] for i in range(len(order))]
    assert seq == sorted(seq, reverse=True)
    loads = [sum(_tile_work(j, Sl, causal) for j in jobs) for jobs in sched]
    assert max(loads) - min(loads) <= max(seq)
    if case == "smoke":
        assert sum(loads) == 16896 and max(loads) <= 132


@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_schedule_tile_reads_only_the_blocks_it_sees(case):
    """A tile's blocks are exactly those with a key some row of the tile
    sees (brute force over the mask on global positions), in the ring's
    order, each read up to its last visible tile."""
    R, rank0, n, B, Sl, Hq, causal, grid = SCHED_CASES[case]
    for jobs in _schedule(case):
        for job in jobs:
            r = job["r"]
            rows = np.arange(job["q0"], min(job["q0"] + ra.BQ, Sl)) + r * Sl
            seen = []
            for i in range(n):
                src = (r - i) % n
                keys = np.arange(Sl) + src * Sl
                vis = (keys[None, :] <= rows[:, None]) if causal else \
                    np.ones((len(rows), Sl), bool)
                if vis.any():
                    last = int(np.nonzero(vis.any(0))[0].max())
                    seen.append((src, last // BK + 1))
            got = [(src, -(-min(Sl, max(0, rows[-1] - r * Sl + off + 1))
                          // BK) if causal else -(-Sl // BK))
                   for src, off in job["blocks"]]
            assert got == seen, (job, seen)


def test_grid_leaves_sms_free_only_while_waiting():
    assert ra.ring_grid(1024, 132, waits=False) == 132
    assert ra.ring_grid(1024, 132, waits=True) == 132 - ra.RESERVED_SMS
    assert ra.ring_grid(5, 132, waits=True) == 5
    assert ra.RESERVED_SMS >= 1


def _staged_run(grid, sms, sched, arrivals, n_ranks):
    """Steps until every block of the grid has done its tiles, or None if
    nothing can move.  Each block holds an SM for the whole kernel and
    takes its tiles in order, a tile waiting for each of its K/V blocks to
    have arrived; the arrivals come one a step in the staged order, each
    copy needing an SM of its own (the worst case: a copy kernel, or an
    NCCL block, rather than the copy engine)."""
    arrived = set(range(n_ranks)) - set(arrivals)     # already here
    pending, pos = list(arrivals), [0] * grid
    step = 0
    while any(p < len(jobs) for p, jobs in zip(pos, sched)):
        moved = False
        if pending and sms - grid >= 1:
            arrived.add(pending.pop(0))
            moved = True
        for c, jobs in enumerate(sched):
            while pos[c] < len(jobs) and all(
                    s in arrived for s, _ in jobs[pos[c]]["blocks"]):
                pos[c] += 1
                moved = True
        if not moved:
            return None
        step += 1
    return step


@pytest.mark.parametrize("grid", [1, 8, 64, 127, 128, 131])
def test_staged_arrivals_finish_below_the_sm_count(grid):
    """A LocalRing(4)'s tiles at the smoke's shape, with no block on the
    card before the launch (the smoke's staged check), on 132 SMs."""
    sched = ra.ring_schedule(4, 0, 4, 2, 1024, 16, True, grid)
    assert _staged_run(grid, 132, sched, [3, 2, 1, 0], 4) is not None


def test_staged_arrivals_stall_at_the_sm_count():
    sched = ra.ring_schedule(4, 0, 4, 2, 1024, 16, True, 132)
    assert _staged_run(132, 132, sched, [3, 2, 1, 0], 4) is None
    # A DeviceRing rank's own block is there before the launch; the grid
    # that waits is capped below the SM count.
    grid = ra.ring_grid(256, 132, waits=True)
    sched = ra.ring_schedule(1, 3, 4, 2, 1024, 16, True, grid)
    assert _staged_run(grid, 132, sched, [2, 1, 0], 4) is not None


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_ring_kernel_matches_plain_on_card():
    """llama_1b's heads at shards of 512 and a ragged 200, D 64 with group
    1, causal and not, over LocalRing(4)'s stacked blocks: out element by
    element at bf16 scale (the kernel rounds P against the running max of
    its 128-key tiles, the plain chain against each block's max) and lse
    at 1e-4; a second launch bit for bit; then the blocks copied into an
    n-slot buffer on a side stream after the launch, each followed by its
    arrival word: bit for bit the in-place result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    n = 4
    for Sl, Hq, Hkv, D, causal in ((512, 16, 8, 128, True),
                                   (200, 16, 8, 128, True),
                                   (512, 12, 12, 64, False)):
        q = torch.randn(n, 2, Sl, Hq, D, generator=g, device="cuda"
                        ).bfloat16()
        k, v = (torch.randn(n, 2, Sl, Hkv, D, generator=g, device="cuda"
                            ).bfloat16() for _ in range(2))
        out, lse = ra.ring_attention_fwd(q, k, v, 0, n, causal)
        out2, lse2 = ra.ring_attention_fwd(q, k, v, 0, n, causal)
        rout, rlse = ra.ring_attention_fwd_ref(q, k, v, 0, n, causal)
        torch.cuda.synchronize()
        got, want = out.float(), rout.float()
        tol = 2 ** -7 * want.abs() + 2 ** -5 * want.square().mean(
            -1, keepdim=True).sqrt() + 1e-6
        assert bool(((got - want).abs() <= tol).all()), (Sl, D, causal)
        assert (lse - rlse).abs().max().item() <= 1e-4
        assert torch.equal(out, out2) and torch.equal(lse, lse2)

        buf = torch.full((n, 2, 2, Sl, Hkv, D), float("nan"), device="cuda",
                         dtype=torch.bfloat16)
        words = torch.zeros(n, dtype=torch.int32, device="cuda")
        side = torch.cuda.Stream()
        torch.cuda._sleep(1)            # loaded before the kernel waits
        side.wait_stream(torch.cuda.current_stream())
        st, sl = ra.ring_attention_fwd(q, buf[:, 0], buf[:, 1], 0, n, causal,
                                       words=words)
        with torch.cuda.stream(side):
            torch.cuda._sleep(2_000_000)
            for src in reversed(range(n)):
                buf[src, 0].copy_(k[src])
                buf[src, 1].copy_(v[src])
                ra.arrive(words, src)
        torch.cuda.synchronize()
        assert torch.equal(st, out) and torch.equal(sl, lse)
