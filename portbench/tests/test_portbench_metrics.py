"""Every per-layer reader on a canned trace, spans and counters."""

import types

import pytest

from portbench import flops, manifest, trace
from portbench.drivers import Steady

latr, phonemesal = manifest.family("latr"), manifest.family("phonemesal")

FLASH = "void attn::attention_tma_kernel<64, attn::DenseBias>(attn::TmaArgs, attn::DenseBias, int, int)"
SAL = "void attn::attention_tma_kernel<64, attn::SalBias<__nv_bfloat16> >(attn::TmaArgs, attn::SalBias<__nv_bfloat16>, int, int)"
MS = 1_000_000


def _slice(ops, t0=0, t1=100 * MS):
    s = types.SimpleNamespace(ops=[trace.Op(*o) for o in ops], t0=t0, t1=t1)
    s.ops.sort(key=lambda o: o.start)
    return s


def _run(family, config, **kw):
    spans = trace.Spans()
    for i in range(4):
        spans.add("loader", i * 25 * MS, i * 25 * MS + 2 * MS)
        spans.add("train_step", i * 25 * MS + 2 * MS, (i + 1) * 25 * MS)
    stats = kw.pop("stats", None)
    base = dict(family=family, c=manifest.config(config)["config"],
                cf=manifest.config(config), spans=spans, slice_steps=4, slice=None,
                steady=Steady(seconds=0.1, ns=(0, 100 * MS), steps=kw.pop("steps", 4), answers=64,
                              stats=stats))
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_train_readers():
    ops = [(FLASH, 2 * MS, 3 * MS), (SAL, 3 * MS, 5 * MS), ("gemm", 4 * MS, 10 * MS),
           ("gemm", 30 * MS, 40 * MS)]
    run = _run(phonemesal, "phonemesal-base", slice=_slice(ops))
    get = lambda name: manifest.reader(name).read(run)  # noqa: E731
    assert get("device_idle.train") == pytest.approx(100 * (1 - 18 / 100))
    assert get("loader.wait_ms.train") == pytest.approx(2.0)
    sal_bound = flops.bound_s(phonemesal.train_calls(run.c), "sal") * 4
    assert get("sal_fused_attention_roofline.train") == pytest.approx(100 * sal_bound / 2e-3)
    flash_bound = flops.bound_s(phonemesal.train_calls(run.c), "flash") * 4
    assert get("flash_attention_roofline.train") == pytest.approx(100 * flash_bound / 1e-3)
    assert get("train.mfu") == pytest.approx(
        100 * phonemesal.train_step_flops(run.c) * 4 / (0.1 * flops.BF16_PEAK_FLOP_S))


def test_serve_readers():
    s0 = {"decode_s": 1.0, "served": 100, "bucket_batches": {"32": 3, "4": 1}}
    s1 = {"decode_s": 1.05, "served": 196, "bucket_batches": {"32": 6, "4": 1}}
    ops = [(FLASH, 0, 1 * MS), (FLASH, 50 * MS, 51 * MS), ("replay", 51 * MS, 80 * MS)]
    run = _run(latr, "latr-base", slice=_slice(ops), slice_stats=(s0, s1), stats=(s0, s1),
               steps=[19] * 60 + [3] * 4)
    get = lambda name: manifest.reader(name).read(run)  # noqa: E731
    assert get("engine.resolve_share.flood") == pytest.approx(0.5)
    assert get("device_idle.serve") == pytest.approx(69.0)
    bound = 3 * flops.bound_s(latr.serve_calls(run.c, 32), "flash")
    assert get("flash_attention_roofline.serve") == pytest.approx(100 * bound / 2e-3)
    work = 60 * latr.served_row_flops(run.c, 19) + 4 * latr.served_row_flops(run.c, 3)
    assert get("serve.mfu") == pytest.approx(100 * work / (0.1 * flops.BF16_PEAK_FLOP_S))


def test_a_reader_that_finds_nothing_returns_none():
    run = _run(latr, "latr-base", slice=_slice([("gemm", 0, MS)]), slice_stats=({}, {}))
    for name in ("flash_attention_roofline.train", "sal_fused_attention_roofline.train"):
        assert manifest.reader(name).read(run) is None
    run.slice = None
    assert manifest.reader("device_idle.train").read(run) is None


def test_busy_is_a_union_and_gaps_are_labelled():
    sl = _slice([("a", 0, 10), ("b", 5, 20), ("c", 30, 40)], 0, 50)
    assert trace.busy_ns(sl.ops) == 30
    spans = trace.Spans()
    spans.add("loader", 18, 35)
    out = trace.breakdown(sl.ops, 0, 50, spans)
    assert dict(out["idle_gaps"]) == {"loader": 10e-9, "other": 10e-9}
    assert out["device_ops"][0][0] in ("b", "a", "c")
