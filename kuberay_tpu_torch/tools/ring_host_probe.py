"""Host cost of the kernel ring's forward, piece by piece, on one card.

The whole ring's forward over ``LocalRing(4)`` at B 2 x S 4096, 16/8
heads of 128, causal (``ring_attention(impl="rdma")``, as
``chip_smoke.py`` times it) makes 10 step launches of about 0.045 ms of
device time each, so its eager time is set by the host's enqueue time.
This prints, in ms: the forward's eager time (CUDA events around 20
back-to-back calls) and host enqueue time (the host's clock around the
same, no synchronisation inside) in three rounds, then the host time of
each piece the forward runs: the three shards, the forward's buffers,
building ``RingSteps``, one step through it and through
``ring_attention_step``, the bare ctypes call (a past block, and a
future block whose kernel returns at once), one exchange iteration
(side stream, rotate, events), ``_Overlap``'s set-up, an event record
and two tensor views.

    python3 -m kuberay_tpu_torch.tools.ring_host_probe

Needs a CUDA device; builds ``csrc/ring_attention.cu`` at first use.
"""

from __future__ import annotations

import time

import torch

from kuberay_tpu_torch.ops import ring_attention as ra
from kuberay_tpu_torch.parallel import ring_kernel as rk
from kuberay_tpu_torch.parallel.mesh import LocalRing
from kuberay_tpu_torch.parallel.ring import ring_attention

B, S, HQ, HKV, D, SP = 2, 4096, 16, 8, 128, 4


def host_ms(fn, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return t


def eager_ms(fn, n: int) -> float:
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ring_host_probe: no CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(B, S, HQ, D, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(B, S, HKV, D, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    ring = LocalRing(SP, "cuda")
    scale = D ** -0.5
    fwd = lambda: ring_attention(q, k, v, ring, impl="rdma")  # noqa: E731
    R, Sl = SP, S // SP
    n = 500
    with torch.no_grad():
        for _ in range(5):
            fwd()
        for _ in range(3):
            print(f"ring fwd: eager {eager_ms(fwd, 20):.4f} ms, host "
                  f"{host_ms(fwd, 20):.4f} ms", flush=True)
        qs, ks, vs = (ring.shard(t) for t in (q, k, v))
        print(f"3 shards: host "
              f"{host_ms(lambda: [ring.shard(t) for t in (q, k, v)], 50):.4f}")
        kv = rk._double_buffer(ks, vs)
        acc = torch.zeros(qs.shape, device="cuda")
        m = torch.full((R, B, HQ, Sl), -1e30, device="cuda")
        l = torch.zeros((R, B, HQ, Sl), device="cuda")
        out = torch.empty_like(qs)
        lse = torch.empty((R, B, HQ, Sl), device="cuda")

        def buffers():
            f32 = dict(dtype=torch.float32, device=qs.device)
            rk._double_buffer(ks, vs)
            torch.zeros(qs.shape, **f32)
            torch.full((R, B, HQ, Sl), -1e30, **f32)
            torch.zeros((R, B, HQ, Sl), **f32)
            torch.empty_like(qs)
            torch.empty((R, B, HQ, Sl), **f32)

        print(f"forward's buffers host {host_ms(buffers, 100):.4f} ms")
        build = lambda: ra.RingSteps(  # noqa: E731
            qs, kv, acc, m, l, out, lse, True, scale)
        print(f"RingSteps init host {host_ms(build, 50):.4f} ms")
        steps = build()
        # One past block (rank 1 against rank 0's K/V), 500 times.
        print(f"steps.step host "
              f"{host_ms(lambda: steps.step(0, 1, Sl, 0, False), n):.4f} ms")
        one = lambda: ra.ring_attention_step(  # noqa: E731
            qs[1], kv[0, 1, 0], kv[0, 1, 1], acc[1], m[1], l[1], Sl, 0,
            True, scale)
        print(f"ring_attention_step host {host_ms(one, n):.4f} ms")
        fn = ra._fn("ring_attention_step_bf16")
        args = [qs[1].data_ptr(), kv[0, 1, 0].data_ptr(),
                kv[0, 1, 1].data_ptr(), acc[1].data_ptr(), m[1].data_ptr(),
                l[1].data_ptr(), None, None, B, Sl, Sl, HQ, HKV, D, Sl, 0, 1,
                0, scale, steps.stream]
        print(f"raw ctypes step host {host_ms(lambda: fn(*args), n):.4f} ms")
        future = list(args)
        future[15] = 2 * Sl                     # k_off past q: returns
        print(f"raw ctypes future host "
              f"{host_ms(lambda: fn(*future), n):.4f} ms")
        smem = ra._fn("ring_attention_step_smem_bytes")
        print(f"ctypes smem query host {host_ms(lambda: smem(D), n):.4f} ms")
        ov = rk._Overlap(qs.device)

        def exchange():
            with ov.exchange(kv):
                ring.rotate(kv[0], out=kv[1])
            ov.record_compute()
            ov.wait_arrival()

        print(f"one exchange iteration host {host_ms(exchange, 100):.4f} ms")
        print(f"_Overlap init host "
              f"{host_ms(lambda: rk._Overlap(qs.device), 100):.4f} ms")
        print(f"Event+record host "
              f"{host_ms(lambda: torch.cuda.Event().record(), n):.4f} ms")
        print(f"two views host "
              f"{host_ms(lambda: (qs[1], kv[0, 1, 0]), n):.4f} ms")
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
