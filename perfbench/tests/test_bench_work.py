"""``perfbench/work.py`` against operations and bytes counted by hand for
each cell's shapes."""

import pytest

from perfbench import work

SIZES_784 = [784, 10]
SIZES_WIDE = [784, 2048, 2048, 10]


def test_operations_per_lane_step():
    assert work.ops_per_lane_step(SIZES_784) == 2 * 7840
    assert work.ops_per_lane_step(SIZES_WIDE) == 2 * (
        784 * 2048 + 2048 * 2048 + 2048 * 10)          # 11,640,832


@pytest.mark.parametrize("sizes,batch,want", [
    # pixels 784 + lanes in 3,136 + lanes out 3,136 + 3 outputs × 40 + 4
    (SIZES_784, 10000, 10000 * (784 + 6272 + 120 + 4) + 15680),
    (SIZES_WIDE, 10000, 10000 * (784 + 6272 + 120 + 4) + 2 * 5820416),
])
def test_batch_call_bytes(sizes, batch, want):
    assert work.batch_call_bytes(sizes, batch) == want


def test_least_time_names_its_bound():
    # WIDE batch call: 10,000 images × 20 steps of 11,640,832 operations
    ops = 10000 * 20 * 11640832
    t, bound = work.least_time(ops, work.batch_call_bytes(SIZES_WIDE,
                                                          10000))
    assert bound == "operations"
    assert t == pytest.approx(ops / 1979e12)
    # 784→10 batch call: bytes set it
    nbytes = work.batch_call_bytes(SIZES_784, 10000)
    t, bound = work.least_time(10000 * 20 * 15680, nbytes)
    assert bound == "bytes"
    assert t == pytest.approx(nbytes / 3.35e12)


def _reader(name):
    from perfbench import harness
    return harness.load_module("metrics", name).read


@pytest.mark.parametrize("cell", ["wide", "snn784"])
def test_batch_readers_on_a_made_up_record(cell):
    # 10 WIDE calls of 10,000 images in 0.2 s; kernels busy 0.15 s of it
    ops = 10 * 10000 * 20 * 11640832
    nbytes = 10 * work.batch_call_bytes(SIZES_WIDE, 10000)
    rec = {"launches": 10, "window_s": 0.2, "images": 100000,
           "work": {"ops": ops, "bytes": nbytes},
           "trace": {"window_s": 0.2, "busy_s": 0.16, "kernel_s": 0.15,
                     "copy_s": 0.01, "device_ops": [],
                     "idle_gaps": [["snn_apply_int", 0.03],
                                   ["readback", 0.01]]}}
    assert _reader("batch_images_per_s." + cell)(rec) == pytest.approx(500000)
    assert _reader("snn_kernels_roofline." + cell)(rec) == pytest.approx(
        100 * max(ops / 1979e12, nbytes / 3.35e12) / 0.15)
    assert _reader("snn_mfu." + cell)(rec) == pytest.approx(
        100 * ops / (0.2 * 1979e12))
    assert _reader("device_idle_pct." + cell)(rec) == pytest.approx(20.0)
    assert _reader("wrapper_idle_ms_per_call." + cell)(rec) == pytest.approx(
        3.0)
    # an untraced record: the trace's readers find nothing
    plain = {k: v for k, v in rec.items() if k != "trace"}
    assert _reader("snn_kernels_roofline." + cell)(plain) is None
    assert _reader("device_idle_pct." + cell)(plain) is None
