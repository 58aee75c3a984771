"""The FLOP and byte counts on hand-worked shapes."""
import pytest
import torch

from benchmark.counts import flops, peaks
from benchmark.counts.read import read_bytes, read_least_s, read_ops


def test_read_at_1088x1920_count_2():
    hw = (1088 // 16) * (1920 // 16)                     # 8160 query and key positions a slot
    assert hw == 8160
    ops = read_ops(1, hw, 2, 128, 512)
    assert ops == 2 * 8160 * (2 * 8160) * 640 == pytest.approx(170.46e9, rel=1e-4)
    # q, two slots' keys and values, the output, once each
    assert read_bytes(1, hw, 2, 128, 512, 2) == 2 * 8160 * (128 + 256 + 1024 + 512)
    assert read_least_s(1, hw, 2, 128, 512, "bf16") * 1e3 == pytest.approx(0.1724, abs=1e-4)
    assert read_least_s(1, hw, 2, 128, 512, "fp32") * 1e3 == pytest.approx(0.3444, abs=1e-4)


def test_read_bound_by_bytes_at_one_short_slot():
    # 16 positions: 2*16*16*640 ops against (16*(128+128+512+512))*4 bytes
    ops, nbytes = read_ops(1, 16, 1, 128, 512), read_bytes(1, 16, 1, 128, 512, 4)
    assert (ops, nbytes) == (327680.0, 81920.0)
    assert read_least_s(1, 16, 1, 128, 512, "fp32") == nbytes / peaks.peak_bytes()


def test_peaks():
    assert peaks.peak_flops("bf16") == 989e12
    assert peaks.peak_flops("fp32") == 495e12          # TF32: the tensor cores' fp32 path
    assert peaks.peak_bytes() == 3.35e12


def test_flop_counter_counts_a_conv_by_hand():
    conv = torch.nn.Conv2d(16, 32, 3, padding=1, bias=False).to("meta")
    x = torch.zeros(2, 16, 10, 12, device="meta")
    assert flops._count(lambda: conv(x)) == 2 * 2 * 32 * 10 * 12 * 16 * 9


def test_stream_parts_at_scale_4():
    parts = flops.stream_parts("joint", 64, 96, scale=4)
    assert set(parts) == {"segment", "memorize", "fba"}
    assert all(v > 0 for v in parts.values())
    # the segment's count leaves the read out: it is the same over 1 or 3 slots
    assert flops.stream_parts("trimap", 64, 96, scale=4)["segment"] == parts["segment"]


def test_train_step_counts_forward_and_backward():
    step = flops.train_step_flops(1, 2, 64, 64, scale=4)
    assert step > 0
    assert flops.train_step_flops(2, 2, 64, 64, scale=4) == 2 * step
