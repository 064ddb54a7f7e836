"""The port's real-text SQL gate (``auron_tpu_torch/models/sqlgate.py``) at
SF 0.02 on the CPU.

- every one of the 24 corpus queries equals its pandas oracle through the
  port's planned-exchange driver and collect task, under
  ``exchange.mode`` mesh and file;
- the reference test's subset (q3, q34, q59, q96, q5a, q93a) equals the
  JAX package's answers over the same frames (the JAX driver on the CPU
  devices of the conftest, file transport as the reference's CPU gate
  runs it): floats at rel 1e-6, every other type exactly;
- the gate has teeth: a mutated golden (in a temporary copy) and a wrong
  oracle both fail their case, a missing golden is drift;
- every unsupported text is diagnosed, table uses match the scans, the
  oracle head refuses a tie across the LIMIT boundary.
"""

import dataclasses
import os
import shutil

import pandas as pd
import pytest

from auron_tpu.models import sqlgate as RG
from auron_tpu_torch.models import sqlgate as PG
from auron_tpu_torch.sql import compile_text
from auron_tpu_torch.sql.catalog import frames_of

TOY_SF = 0.02
SUBSET = ["q3", "q34", "q59", "q96", "q5a", "q93a"]
NAMES = [c.name for c in PG.CASES]
#: device batches of the catalog per transport, shared by that transport's
#: cases (a gate run uploads each view once)
_CACHES: dict = {"mesh": {}, "file": {}}


@pytest.fixture(scope="module")
def tables():
    return PG.gate_tables(TOY_SF)


@pytest.fixture(scope="module")
def frames(tables):
    return frames_of(tables)


@pytest.mark.parametrize("mode", ["mesh", "file"])
@pytest.mark.parametrize("name", NAMES)
def test_corpus_query_equals_its_oracle(tables, frames, name, mode):
    rec, = PG.run_gate(TOY_SF, names=[name], device="cpu", conf={"exchange.mode": mode},
                       tables=tables, frames=frames, cache=_CACHES[mode])
    assert rec["ok"], rec["error"]
    run, = rec["runs"]
    assert [ex["mode"] for ex in run["exchanges"]] == \
        [mode] * PG.plan_text(compile_text(PG.case_by_name(name).sql,
                                           PG.gate_catalog())).count("mesh_exchange")
    assert run["launches"] == dict.fromkeys(
        ("bitonic_sort", "bitonic_merge", "murmur3_pmod", "partition_histogram"), 0)
    assert run["peak_bytes"] is None and rec["engine_s"] == [run["engine_s"]]
    assert rec["compile_s"] > 0 and rec["oracle_s"] >= 0


def _jax_answer(name, frames):
    """The JAX package's answer of one corpus case (its driver on the CPU
    devices, file transport)."""
    from auron_tpu.parallel.mesh import make_mesh
    from auron_tpu.utils.config import EXCHANGE_MODE, Configuration

    lq = RG.compile_text(RG.case_by_name(name).sql, RG.gate_catalog())
    return RG.execute(lq, frames, make_mesh(2), conf=Configuration().set(EXCHANGE_MODE, "file"))


@pytest.mark.parametrize("name", SUBSET)
def test_subset_equals_the_jax_gate(tables, frames, name):
    from auron_tpu_torch.models.compare import compare_frames
    from auron_tpu_torch.parallel.mesh import make_mesh

    lq = compile_text(PG.case_by_name(name).sql, PG.gate_catalog())
    got = PG.execute(lq, tables, make_mesh(2, "cpu"), conf={"exchange.mode": "file"})
    want = _jax_answer(name, frames)
    assert len(want) and list(got.columns) == list(want.columns)
    assert [str(t) for t in got.dtypes] == [str(t) for t in want.dtypes]
    assert compare_frames(got, want, 1e-6, sorted_rows=True) is None


def test_mutated_golden_fails(tmp_path, monkeypatch, tables, frames):
    shutil.copytree(PG.GOLDEN_DIR, tmp_path / "sql")
    monkeypatch.setattr(PG, "GOLDEN_DIR", str(tmp_path / "sql"))
    rec, = PG.run_gate(TOY_SF, names=["q3"], device="cpu", tables=tables, frames=frames)
    assert rec["ok"], rec["error"]
    path = tmp_path / "sql" / "q3.txt"
    path.write_text(path.read_text().replace("hash_agg", "smash_agg", 1))
    rec, = PG.run_gate(TOY_SF, names=["q3"], device="cpu", tables=tables, frames=frames)
    assert not rec["ok"] and "drift" in rec["error"] and not rec["runs"]
    os.remove(path)
    rec, = PG.run_gate(TOY_SF, names=["q3"], device="cpu", tables=tables, frames=frames)
    assert not rec["ok"] and "no golden" in rec["error"] and not path.exists()


def test_wrong_oracle_fails(tables, frames):
    from auron_tpu_torch.parallel.mesh import make_mesh

    case = PG.case_by_name("q96")

    def wrong_oracle(fr):
        df = case.oracle(fr).copy()
        df.iloc[0, 0] = df.iloc[0, 0] + 1
        return df

    broken = dataclasses.replace(case, oracle=wrong_oracle)
    rec = PG.run_case(broken, tables, frames, make_mesh(2, "cpu"), PG.gate_catalog(), 2, {},
                      1e-6, warmup=True, runs=2)
    assert not rec["ok"] and rec["error"] and len(rec["runs"]) == 2 and rec["warm"]
    rec = PG.run_case(case, tables, frames, make_mesh(2, "cpu"), PG.gate_catalog(), 2, {},
                      1e-6, oracle=lambda: (wrong_oracle(frames), 0.0))
    assert not rec["ok"] and rec["error"]


def test_unsupported_corpus_all_diagnosed():
    recs = PG.run_unsupported(PG.gate_catalog())
    assert len(recs) == 11 and all(r["ok"] and r["line"] >= 1 for r in recs), recs
    assert [r["construct"] for r in recs] == [c for _, c in RG.UNSUPPORTED.values()]


def test_table_uses_match_emitted_scans():
    """``LoweredQuery.tables`` lists exactly the resources the plans scan
    (the gate uploads nothing that no plan reads), and the q34 shape does
    not replicate the fact table."""
    from auron_tpu_torch.sql.lowering import STAGE_RID, _scan_rids

    for case in PG.CASES:
        lq = compile_text(case.sql, PG.gate_catalog())
        scanned = _scan_rids(lq.distributed)
        if lq.collect is not None:
            scanned |= _scan_rids(lq.collect)
        scanned.discard(STAGE_RID)
        assert {u.rid for u in lq.tables} == scanned, case.name
    lq = compile_text(PG.case_by_name("q34").sql, PG.gate_catalog())
    assert "sql:store_sales:all" not in {u.rid for u in lq.tables}


def test_oracle_head_tie_rules():
    base = PG.case_by_name("q3")
    df = pd.DataFrame({"k": [1, 1, 2, 3], "v": [10, 20, 30, 40]})
    c = dataclasses.replace(base, order=("k",), ascending=(True,), limit=3)
    assert PG.oracle_head(df, c)["v"].tolist() == [10, 20, 30]
    df2 = pd.DataFrame({"k": [1, 2, 2, 2], "v": [10, 20, 30, 40]})
    c2 = dataclasses.replace(base, order=("k",), ascending=(True,), limit=2)
    with pytest.raises(PG.TieError):
        PG.oracle_head(df2, c2)
    df3 = pd.DataFrame({"k": [1, 2, 2], "v": [10, 20, 20]})
    assert len(PG.oracle_head(df3, c2)) == 2


def test_gate_records_runs_and_the_exchanges(tables, frames):
    """A warm-up and two timed runs: each answer held to the oracle, each
    timed run with its wall, the driver's stage walls, its exchanges
    (routing matrix, routed bytes) and the collect task's wall."""
    st: dict = {}
    rec, = PG.run_gate(TOY_SF, names=["q65"], device="cpu", tables=tables, frames=frames,
                       runs=2, warmup=True, stats=st)
    assert rec["ok"], rec["error"]
    assert st == {} and len(rec["engine_s"]) == 2 and rec["warm"]["engine_s"] > 0
    for run in [rec["warm"], *rec["runs"]]:
        assert len(run["exchanges"]) == 2
        assert run["shuffle_bytes"] == sum(ex["routed_bytes"] for ex in run["exchanges"]) > 0
        assert {"reduce_s", "collect_s"} <= set(run["walls"])
        assert sum(map(sum, run["exchanges"][0]["routing"])) > 0


def test_gate_builds_its_tables_from_the_scale_factor():
    st: dict = {}
    rec, = PG.run_gate(0.005, names=["q96"], device="cpu", stats=st)
    assert rec["ok"], rec["error"]
    assert st["tables_s"] > 0 and st["frames_s"] > 0


def test_gate_on_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda gate runs in tests/test_torch_cuda.py")
    with pytest.raises(RuntimeError, match="is_available"):
        PG.run_gate(0.005, names=["q96"], device="cuda")
