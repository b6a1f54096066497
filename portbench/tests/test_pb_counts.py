"""counts.py on hand-worked shapes."""

import pytest

from portbench import counts
from portbench.harness import HERE, read_json

MISTRAL = counts.Dims.of(read_json(HERE / "configs" / "mistral-7b-v0.3.json"))
SMOL = counts.Dims.of(read_json(HERE / "configs" / "smollm2-1.7b.json"))
H100 = counts.peaks("NVIDIA H100 80GB HBM3")


def test_parameter_counts():
    # 2 * 32768 * 4096 + 32 * (2 * 4096^2 + 2 * 4096 * 1024 + 3 * 4096 *
    # 14336 + 2 * 4096) + 4096
    assert MISTRAL.params == 7_248_023_552
    # 49152 * 2048 (tied) + 24 * (4 * 2048^2 + 3 * 2048 * 8192 + 2 * 2048)
    # + 2048
    assert SMOL.params == 1_711_376_384
    assert MISTRAL.kv_bytes_per_token == 128 * 1024


def test_train_flops_per_token():
    assert counts.train_flops_per_token(SMOL, 2048) / 1e9 == \
        pytest.approx(11.476, abs=1e-3)
    assert counts.train_flops_per_token(SMOL, 8192) / 1e9 == \
        pytest.approx(15.100, abs=1e-3)


def test_peaks():
    assert H100 == {"bf16_flops": 989e12, "f32_flops": 67e12,
                    "bytes": 3.35e12}
    assert counts.peaks("cpu") is None


def test_visible_pairs_and_prefill_flops():
    assert counts.visible_pairs(0, 4) == 10
    assert counts.visible_pairs(3, 2) == 2 * 3 + 3
    # one token after 99 cached: 100 pairs
    f = counts.forward_flops(MISTRAL, 99, 1, 1)
    linear = 2 * (MISTRAL.params - 2 * 32768 * 4096 - 32 * 8192 - 4096)
    assert f == linear + 4 * 32 * 32 * 128 * 100 + 2 * 4096 * 32768


def test_paged_decode_bound_at_the_kernel_tables_shape():
    # PERF.md's kernel table: 8 rows, 5242 live positions, 32/8 heads of
    # 128, block 16: 0.00645 ms, bound by bytes.
    ctx = [655] * 7 + [5242 - 7 * 655]
    bound = counts.paged_decode_bound_s(MISTRAL, ctx, 16, H100)
    assert bound * 1e3 == pytest.approx(0.00645, rel=0.01)


def test_decode_step_bound_is_the_weights_at_one_row():
    bound = counts.decode_step_bound_s(MISTRAL, [1], H100)
    weights = 2 * (MISTRAL.params - 32768 * 4096 + 4096)
    assert bound == pytest.approx((weights + 2 * 128 * 1024) / 3.35e12)


def test_flash_bound_is_compute_at_train_shapes():
    b = counts.flash_bound_s("fwd", 16, 2048, 32, 32, 64, H100)
    pairs = 16 * 32 * 2048 * 2049 // 2
    assert b == pytest.approx(4 * 64 * pairs / 989e12)
    assert counts.flash_bound_s("bwd_dkv", 16, 2048, 32, 32, 64, H100) == \
        pytest.approx(2 * b)
