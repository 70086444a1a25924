"""The yardstick's arithmetic against hand-worked shapes: the kernels'
operations and bytes, the model FLOP counts behind the mfu metrics, the
percentile over every request."""
import json
import math
from types import SimpleNamespace

import _bench_path  # noqa: F401
import pytest

from bench.harness import flops, peaks
from bench.harness.manifest import BENCH, load_module
from bench.harness.record import Record
from bench.harness.stats import percentile

TOPK = load_module("kernels", "memory_topk")
FLASH = load_module("kernels", "flash_attention")


def test_store_read_counts_at_the_cell_shape():
    c = {"C": 21_080_860, "E": 384, "B": 256, "k": 1}
    assert TOPK.flops(c) == 2 * 256 * 21_080_860 * 384 == 4_144_665_722_880
    assert TOPK.bytes_moved(c) == 4 * (21_080_860 * 384 + 21_080_860 +
                                       256 * 384 + 2 * 256)
    # compute-bound at B = 256: 61.9 ms at 67 TFLOP/s against 9.69 ms
    assert peaks.bound_s(TOPK.flops(c), TOPK.bytes_moved(c), "float32") == \
        pytest.approx(4_144_665_722_880 / 67e12)
    small = {"C": 4096, "E": 384, "B": 1, "k": 4}
    assert peaks.bound_s(TOPK.flops(small), TOPK.bytes_moved(small),
                         "float32") == pytest.approx(
        4 * (4096 * 385 + 384 + 8) / 3.35e12)


@pytest.mark.parametrize("Sq,causal,window,pairs", [
    (4, True, 0, 10), (4, False, 0, 16), (5, True, 2, 9), (1, True, 0, 1)])
def test_flash_pairs(Sq, causal, window, pairs):
    c = {"B": 1, "Sq": Sq, "Sk": Sq, "H": 1, "KV": 1, "hd": 1,
         "causal": causal, "window": window, "itemsize": 2}
    assert FLASH.pairs(c) == pairs


def test_flash_counts_at_the_cell_shape():
    c = {"B": 4, "Sq": 4096, "Sk": 4096, "H": 16, "KV": 16, "hd": 128,
         "causal": True, "window": 0, "itemsize": 2, "dtype": "bfloat16"}
    assert FLASH.flops(c) == 4 * 4 * 16 * 128 * 4096 * 4097 / 2
    assert FLASH.bytes_moved(c) == 2 * 4 * 128 * 4 * 4096 * 16
    assert peaks.bound_s(FLASH.flops(c), FLASH.bytes_moved(c), "bfloat16") \
        == pytest.approx(FLASH.flops(c) / 989e12)


def test_olmoe_call_flops_count_active_weights_twice():
    model = json.loads((BENCH / "configs" / "olmoe-1b-7b.json").read_text(
    ))["model"]
    per_layer = 2048 * 128 * (2 * 16 + 2 * 16) + 2048 * 64 + \
        8 * 3 * 2048 * 1024
    assert flops.layer_weights(model) == per_layer
    want = (2 * per_layer * 16 * 4 * 4096 +
            4 * 16 * 16 * 128 * 4 * 4096 * 4097 // 2 + 2 * 2048 * 50304 * 4)
    assert flops.prefill_flops(model, 4, 4096, 4) == want
    assert want == pytest.approx(3.96e13, rel=0.01)
    # the engine's own count is a training count: 6 per weight, all tokens
    assert want < 6 * (per_layer * 16) * 4 * 4096


def test_generate_counts_a_decode_step_per_new_token():
    m = {"num_layers": 1, "d_model": 4, "num_heads": 1, "num_kv_heads": 1,
         "head_dim": 4, "d_ff": 8, "vocab_size": 10}
    w = flops.layer_weights(m)
    assert w == 4 * 4 * 4 + 3 * 4 * 8
    assert flops.generate_flops(m, [3], 2) == (
        2 * w * 3 + 4 * 4 * 6 + 2 * 4 * 10) + (2 * w + 4 * 4 * 4 + 2 * 4 * 10)


def test_p95_is_taken_over_every_request():
    lat = [1.0] * 94 + [50.0] * 6
    assert percentile(lat, 95) == 50.0
    assert percentile(lat[:-1], 95) == 50.0
    assert percentile(list(range(1, 101)), 95) == 95
    rec = Record(latencies_ms=lat)
    assert load_module("metrics", "answer_ms_p95").read(rec) == 50.0


def test_rates_divide_the_whole_window():
    rec = Record(requests=512, tokens=16388 * 3, window_s=2.0)
    assert load_module("metrics", "requests_per_s").read(rec) == 256.0
    assert load_module("metrics", "tokens_per_s").read(rec) == 16388 * 1.5


def test_roofline_pairs_launches_with_recorded_shapes():
    c = {"C": 1000, "E": 4, "B": 2, "k": 1}
    ev = [("topk_scan_kernel", 0.0, 10.0), ("other", 10.0, 30.0),
          ("topk_scan_kernel", 30.0, 40.0)]
    trace = SimpleNamespace(matching=lambda m: [e for e in ev if m(e[0])],
                            device_s=lambda m: sum(
                                t - s for n, s, t in ev if m(n)) / 1e6)
    rec = Record(trace=trace, kernel_calls={"memory_topk": [c, c]}, steps=2)
    got = load_module("metrics", "topk_roofline.rar").read(rec)
    b = peaks.bound_s(TOPK.flops(c), TOPK.bytes_moved(c), "float32")
    assert got == pytest.approx(100 * 2 * b / 20e-6)
    assert load_module("metrics", "topk_ms.rar").read(rec) == \
        pytest.approx(0.01)
    rec.kernel_calls = {"memory_topk": [c]}          # unpaired: no reading
    assert load_module("metrics", "topk_roofline.rar").read(rec) is None
    assert math.isfinite(got)
