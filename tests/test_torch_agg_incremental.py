"""The incremental aggregate path of the port (``exec/agg_exec.py``: the
sorted-state probe/scatter ``_ProbeScatter``, the merge-path ``_merge``,
``ops/segments.segment_merged``) against the JAX ``HashAggExec`` with the
same conf, and against itself with the keys off. The ports of
``tests/test_agg_exec.py:558`` (k-deep interleaved misses), ``:634`` (every
probe-foldable aggregate bit-identical on dyadic values) and ``:758`` (a
spill park keeps ``first``'s stream order), a merge-path merge equal to the
concat-and-sort merge, and ``exec.agg.incremental.fp.bits=4`` forcing
fingerprint collisions with no group split in the final output. Every case
runs with the keys on and off; the answers are compared exactly (the float
values are dyadic, so every summation order gives the same bits)."""

import numpy as np
import pytest

from auron_tpu.exec.agg_exec import AggExpr as JAgg
from auron_tpu.exec.agg_exec import HashAggExec as JHashAgg
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.basic import MemoryScanExec as JScan
from auron_tpu.exprs import ir as jir
from auron_tpu.utils.config import Configuration as JConf
from auron_tpu.utils.config import conf_scope as jconf_scope

from auron_tpu_torch.exec import agg_exec as pagg_mod
from auron_tpu_torch.exec.agg_exec import AggExpr as PAgg
from auron_tpu_torch.exec.agg_exec import HashAggExec as PHashAgg
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.basic import MemoryScanExec as PScan
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.utils.config import Configuration as PConf
from torch_carry import canon, carry, jax_batch, rows

KEYS = ("exec.agg.incremental.fingerprint", "exec.agg.incremental.probe",
        "exec.agg.incremental.mergepath")


def _conf(mode: str, depth: int = 3, fp_bits: int = 64) -> dict:
    c = {k: mode for k in KEYS}
    c.update({"batch.size": "2048", "runtime.transfer.window.depth": str(depth),
              "partial.agg.skipping.enable": "false",
              "exec.agg.incremental.fp.bits": str(fp_bits)})
    return c


def _aggs(specs, mod):
    Agg, ir = (JAgg, jir) if mod == "jax" else (PAgg, pir)
    return [(Agg(f, None if c is None else ir.col(c)), n) for f, c, n in specs]


def _jax(frames, specs, conf: dict):
    jc = JConf(dict(conf))
    with jconf_scope(jc):
        batches = [jax_batch({"k": k, "v": v}) for k, v in frames]
        aggs = _aggs(specs, "jax")
        p = JHashAgg(JScan.single(batches), [(jir.col(0), "k")], aggs, "partial")
        mid = list(p.execute(0, JCtx(conf=jc)))
        f = JHashAgg(JScan.single(mid), [(jir.col(0), "k")], aggs, "final")
        return canon(rows(list(f.execute(0, JCtx(conf=jc)))))


def _port(frames, specs, conf: dict):
    pc = PConf(dict(conf))
    batches = [carry(jax_batch({"k": k, "v": v})) for k, v in frames]
    aggs = _aggs(specs, "port")
    p = PHashAgg(PScan([batches], batches[0].schema), [(pir.col(0), "k")], aggs, "partial")
    ctx = PCtx(conf=pc, device="cpu")
    mid = list(p.execute(0, ctx))
    f = PHashAgg(PScan([mid], p.schema), [(pir.col(0), "k")], aggs, "final")
    fctx = PCtx(conf=pc, device="cpu")
    out = canon(rows(list(f.execute(0, fctx))))
    return out, ctx.metrics.values, fctx.metrics.values


def _pool(n: int, mult: int = 1_000_003, off: int = 7) -> np.ndarray:
    return np.arange(n, dtype=np.int64) * mult + off  # too spread for the dense table


def _interleaved_frames(seed: int):
    rng = np.random.default_rng(seed)
    pool = _pool(40_000)
    keys = [pool[i * 2048:(i + 1) * 2048] for i in range(17)]
    for i in range(12):
        if i % 3 == 2:  # brand-new keys: misses
            keys.append(900_000_000_000 + i * 10_000 + rng.integers(0, 200, 512))
        else:
            keys.append(rng.choice(pool[:34_000], 512))
    return [(k, np.ones(len(k))) for k in keys]


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("depth", [1, 3, 6])
def test_probe_scatter_k_deep_interleaved_misses(mode, depth):
    """Hit batches scatter into the state while miss batches resolve k
    batches late and re-enter the generic path narrowed to their misses:
    every row counts once, equal to the reference and to the keys off."""
    frames = _interleaved_frames(4)
    specs = [("count_star", None, "c"), ("sum", 1, "s")]
    conf = _conf(mode, depth)
    got, m, _ = _port(frames, specs, conf)
    assert got == _jax(frames, specs, conf)
    all_k = np.concatenate([k for k, _ in frames])
    uniq, cnt = np.unique(all_k, return_counts=True)
    assert [r[0] for r in got] == uniq.tolist()
    assert [r[1] for r in got] == cnt.tolist()
    assert [r[2] for r in got] == cnt.astype(float).tolist()
    if mode == "on":
        assert m.get("probe_hit_rows", 0) > 0 and m.get("probe_miss_batches", 0) > 0, m
    else:
        assert "probe_hit_rows" not in m


ALL_KINDS = [("sum", 1, "s"), ("count", 1, "c"), ("count_star", None, "cs"),
             ("avg", 1, "a"), ("min", 1, "mn"), ("max", 1, "mx"),
             ("first_ignores_null", 1, "f"), ("first", 1, "f2")]


def _dyadic_frames(seed: int):
    rng = np.random.default_rng(seed)
    pool = _pool(36_000, off=13)
    keys = [pool[i * 2048:(i + 1) * 2048] for i in range(17)]
    keys += [rng.choice(pool[:30_000], 512) for _ in range(8)]
    return [(k, rng.integers(-(1 << 20), 1 << 20, len(k)) / 1024.0) for k in keys]


def test_probe_scatter_all_agg_kinds_bit_identical():
    """Every probe-foldable aggregate through a probing stream equals the
    keys-off path and the reference, bit for bit."""
    frames = _dyadic_frames(8)
    on, m_on, _ = _port(frames, ALL_KINDS, _conf("on"))
    off, m_off, _ = _port(frames, ALL_KINDS, _conf("off"))
    assert m_on.get("probe_hit_rows", 0) > 0, "the stream never probed"
    assert m_on.get("probe_batches", 0) > 0 and "probe_batches" not in m_off
    assert on == off
    assert on == _jax(frames, ALL_KINDS, _conf("on"))
    assert off == _jax(frames, ALL_KINDS, _conf("off"))


@pytest.mark.parametrize("mode", ["on", "off"])
def test_probe_scatter_spill_park_preserves_first_stream_order(monkeypatch, mode):
    """A spill parks the state mid-window (simulated by clearing the state's
    fingerprint order right after the miss batch's fold): the next batch
    goes generic at once, so the probe drains its window first and
    ``first`` keeps the pending miss batch's value."""
    pool = _pool(40_000)
    frames = [(pool[i * 2048:(i + 1) * 2048], np.zeros(2048)) for i in range(17)]
    frames.append((pool[:512], np.zeros(512)))  # 18: hits, the probe engaged
    band = 900_000_000_000 + np.arange(512, dtype=np.int64)
    frames.append((band, np.ones(512)))  # 19: a miss batch, deferred
    frames.append((band, np.full(512, 2.0)))  # 20: after the park, same keys
    park_after = 19
    calls = {"n": 0, "folded": {}}
    orig = pagg_mod._ProbeScatter.fold

    def fold(self, b):
        res = orig(self, b)
        calls["n"] += 1
        calls["folded"][calls["n"]] = res[0]
        if calls["n"] == park_after:
            with self.table._lock:
                st = self.table.state
                assert st is not None and st._fp_order
                st._fp_order = False  # what a spill does to the probe's view
        return res

    monkeypatch.setattr(pagg_mod._ProbeScatter, "fold", fold)
    specs = [("first", 1, "f"), ("count_star", None, "c")]
    conf = _conf(mode, depth=6)
    got, _, _ = _port(frames, specs, conf)
    if mode == "on":
        assert calls["folded"][park_after], "the miss batch did not probe-fold"
        assert not calls["folded"][park_after + 1], "the park did not disengage the probe"
    else:
        assert calls["n"] == 0
    band_rows = [r for r in got if r[0] >= 900_000_000_000]
    assert [r[2] for r in band_rows] == [2] * len(band)
    assert [r[1] for r in band_rows] == [1.0] * len(band)
    monkeypatch.setattr(pagg_mod._ProbeScatter, "fold", orig)
    assert got == _jax(frames, specs, conf)


def test_merge_path_equals_concat_and_sort():
    """A merge of fingerprint-sorted parts by merge rank (no sort) equals
    the concat-and-re-sort merge: the same groups in the same order with
    the same accumulators."""
    import torch

    frames = _dyadic_frames(3)
    specs = [("sum", 1, "s"), ("count_star", None, "c"), ("min", 1, "mn"),
             ("first", 1, "f")]
    batches = [carry(jax_batch({"k": k, "v": v})) for k, v in frames[:6]]
    aggs = _aggs(specs, "port")
    ex = PHashAgg(PScan([batches], batches[0].schema), [(pir.col(0), "k")], aggs, "partial")
    parts = [ex._to_intermediate(b, PConf(_conf("on"))) for b in batches]
    assert all(p._fp_order for p in parts)
    path = ex._merge(list(parts), conf=PConf(_conf("on")))
    legacy = ex._merge(list(parts), conf=PConf({**_conf("on"),
                                                "exec.agg.incremental.mergepath": "off"}))
    assert path._fp_order and torch.equal(path._inc_fp, legacy._inc_fp)
    assert rows([path]) == rows([legacy])


@pytest.mark.parametrize("mode", ["on", "off"])
def test_tiny_fingerprints_collide_without_split_groups(mode):
    """``exec.agg.incremental.fp.bits=4``: 16 fingerprints for thousands of
    keys, so nearly every fingerprint run holds several keys. The collision
    flags keep the probe and the merge-path off those runs, the final merge
    dedups by the full-word sort, and no group comes out split."""
    frames = _interleaved_frames(11)
    specs = [("count_star", None, "c"), ("sum", 1, "s"), ("first", 1, "f")]
    conf = _conf(mode, depth=3, fp_bits=4)
    got, m, fm = _port(frames, specs, conf)
    keys = [r[0] for r in got]
    assert len(keys) == len(set(keys)), "a group came out split"
    assert got == _jax(frames, specs, conf)
    assert got == _port(frames, specs, _conf(mode))[0]
    if mode == "on":
        assert m.get("fp_collision_batches", 0) > 0 or fm.get("fp_collision_batches", 0) > 0
