"""The counted work against hand counts (chip_smoke.py's train_flops and
PERF.md's kernel table)."""

import pytest

from portbench import flops, manifest


def _c(name):
    return manifest.config(name)["config"]


def test_latr_train_step_is_chip_smokes_count():
    # chip_smoke.py train_flops(16)["step_tflop"]
    assert flops.latr_train_step_flops(_c("latr-base"), 16) / 1e12 == pytest.approx(6.74, abs=0.01)


def test_per_call_bounds_match_the_kernel_table():
    c = _c("latr-base")
    serve = {(k.lq, k.lk): flops.call_bound_s(k) * 1e3 for k in flops.latr_serve_calls(c, 32)}
    assert serve[(197, 197)] == pytest.approx(0.0116, abs=5e-5)
    assert serve[(327, 327)] == pytest.approx(0.0207, abs=5e-5)
    train = {(k.lq, k.lk): flops.call_bound_s(k) * 1e3 for k in flops.latr_train_calls(c, 16)}
    assert train[(197, 197)] == pytest.approx(0.0058, abs=5e-5)
    assert train[(327, 327)] == pytest.approx(0.0111, abs=5e-5)
    assert train[(127, 127)] == pytest.approx(0.0040, abs=5e-5)
    assert train[(127, 327)] == pytest.approx(0.0067, abs=5e-5)
    # per LaTr batch of 32 / per LaTr step
    assert flops.bound_s(flops.latr_serve_calls(c, 32), "flash") * 1e3 == pytest.approx(0.388,
                                                                                     abs=1e-3)
    assert flops.bound_s(flops.latr_train_calls(c, 16), "flash") * 1e3 == pytest.approx(0.331,
                                                                                     abs=1e-3)


def test_phonemesal_bounds_and_step():
    c = _c("phonemesal-base")
    calls = flops.phonemesal_train_calls(c, 16)
    assert flops.call_bound_s(calls[0]) * 1e3 == pytest.approx(0.0108, abs=5e-5)
    assert flops.bound_s(calls, "sal") * 1e3 == pytest.approx(0.129, abs=1e-3)
    assert flops.bound_s(calls, "flash") * 1e3 == pytest.approx(0.027, abs=1e-3)
    assert 3.5 < flops.phonemesal_train_step_flops(c, 16) / 1e12 < 4.5


def test_served_row_counts_the_encode_and_every_step():
    c = _c("latr-base")
    row = flops.latr_served_row_flops(c, 19)
    vit, enc = flops.latr_parts(c, 1)
    assert row > vit + enc
    assert 110e9 < row < 135e9  # ~4 TFLOP a batch of 32
    assert flops.latr_served_row_flops(c, 20) > row


def test_causal_counts_the_lower_triangle():
    full = flops.Call("flash", 2, 3, 10, 10, 8)
    causal = full._replace(causal=True)
    assert flops.call_flops(causal) == flops.call_flops(full) * 55 / 100


def test_phonemesal_serving_counts():
    c = _c("phonemesal-base")
    calls = flops.phonemesal_serve_calls(c, 32)
    # PERF.md's kernel table: SaL encoder serving at B=32, and a SaL batch
    assert flops.call_bound_s(calls[0]) * 1e3 == pytest.approx(0.0207, abs=5e-5)
    assert flops.bound_s(calls, "sal") * 1e3 == pytest.approx(0.248, abs=1e-3)
    assert flops.bound_s(calls, "flash") == 0
    # the 20th decode step by hand: 4 layers of q, k, v, o, cross q, o and
    # an FFN of 2048, the 253-id head, self-attention over 20 positions and
    # cross-attention over 336, 12 heads of 64
    step = 2 * 4 * (6 * 768 ** 2 + 2 * 768 * 2048) + 2 * 768 * 253 \
        + 4 * (4 * 12 * 20 * 64 + 4 * 12 * 336 * 64)
    assert flops.phonemesal_served_row_flops(c, 20) - flops.phonemesal_served_row_flops(c, 19) \
        == step
    assert flops.phonemesal_served_row_flops(c, 0) > flops.phonemesal_encode(c, 1)
