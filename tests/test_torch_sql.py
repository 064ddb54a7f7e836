"""The port's SQL front end (``auron_tpu_torch/sql/``) against the
reference's (``auron_tpu/sql/``): the same tokens, ASTs, renderings,
diagnostics, plan bytes, plan texts, digests and catalog rows.

- every corpus and unsupported text of the reference's gate tokenizes to
  the same (kind, text, position) and parses to the same AST, positions
  included; ``to_sql`` renders it as the reference does and the rendering
  round-trips, also over the reference fuzz test's generator seeds;
- every unsupported text and fuzz construct raises ``SqlUnsupported`` with
  the reference's construct, line and column;
- each of the 24 corpus texts at ``n_parts`` 2 and 4 lowers to the same
  plan bytes (the reference's ``SerializeToString(deterministic=True)``),
  schema and table uses; at 2 its plan text equals the checked-in golden;
- ``build_tables`` at SF 0.02 gives the reference's frames, column for
  column, dtype and NULLs included;
- compiling needs no JAX, pyarrow, pandas or google.protobuf, and touches
  no CUDA device.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
import textwrap

import pandas as pd
import pytest

from auron_tpu.models import sqlgate as RG
from auron_tpu.models import tpcds as RT
from auron_tpu.sql import SqlUnsupported as RUnsupported
from auron_tpu.sql import compile_text as r_compile
from auron_tpu.sql import digest as RD
from auron_tpu.sql import lexer as RL
from auron_tpu.sql import parse as r_parse
from auron_tpu.sql import sqlast as RA
from auron_tpu.sql.catalog import TABLES
from auron_tpu.sql.catalog import build_tables as r_build_tables
from auron_tpu_torch.models import sqlgate as PG
from auron_tpu_torch.models import tpcds as PT
from auron_tpu_torch.sql import SqlUnsupported as PUnsupported
from auron_tpu_torch.sql import compile_text as p_compile
from auron_tpu_torch.sql import digest as PD
from auron_tpu_torch.sql import lexer as PL
from auron_tpu_torch.sql import parse as p_parse
from auron_tpu_torch.sql import sqlast as PA
from auron_tpu_torch.sql.catalog import build_tables as p_build_tables
from auron_tpu_torch.sql.catalog import frames_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str):
    """A private copy of a reference test module (its generator and cases)."""
    spec = importlib.util.spec_from_file_location(
        f"_torch_sql_{name}", os.path.join(REPO, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FUZZ = _load("test_sql_fuzz")
CORPUS = {c.name: c.sql for c in RG.CASES}
UNSUPPORTED = {name: sql for name, (sql, _) in RG.UNSUPPORTED.items()}
TEXTS = {**CORPUS, **UNSUPPORTED}


def _plain(node, with_pos: bool):
    """An AST node as nested tuples of its class name and fields (the two
    packages' dataclasses compared structurally); ``with_pos`` keeps the
    source positions, which dataclass equality leaves out."""
    if dataclasses.is_dataclass(node):
        fields = [f for f in dataclasses.fields(node) if with_pos or f.compare]
        return (type(node).__name__,) + tuple(
            (f.name, _plain(getattr(node, f.name), with_pos)) for f in fields)
    if isinstance(node, (tuple, list)):
        return tuple(_plain(x, with_pos) for x in node)
    return node


def _tokens(mod, sql):
    return [(t.kind, t.text, t.pos.line, t.pos.col, t.pos.offset, t.quoted)
            for t in mod.tokenize(sql)]


@pytest.mark.parametrize("name", list(TEXTS))
def test_tokens_and_ast_equal_the_reference(name):
    sql = TEXTS[name]
    assert _tokens(PL, sql) == _tokens(RL, sql)
    if name in CORPUS:
        assert _plain(p_parse(sql), True) == _plain(r_parse(sql), True)


@pytest.mark.parametrize("name", list(CORPUS))
def test_rendering_equals_the_reference_and_roundtrips(name):
    ast = p_parse(CORPUS[name])
    text = PA.to_sql(ast)
    assert text == RA.to_sql(r_parse(CORPUS[name]))
    assert p_parse(text) == ast
    assert PA.to_sql(p_parse(text)) == text


@pytest.mark.parametrize("seed", range(40))
def test_generated_ast_reads_and_renders_as_the_reference(seed):
    """The reference fuzz test's generated AST, rendered by the reference:
    the port parses it to the same tree and renders the same text."""
    ast = FUZZ.Gen(seed).query(depth=3)
    text = RA.to_sql(ast)
    got = p_parse(text)
    assert _plain(got, False) == _plain(ast, False), text
    assert PA.to_sql(got) == text


def _diagnosis(compile_fn, exc, sql, catalog):
    with pytest.raises(exc) as ei:
        compile_fn(sql, catalog)
    e = ei.value
    return e.construct, e.pos.line, e.pos.col, str(e)


@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_unsupported_text_is_diagnosed_as_the_reference(name):
    sql, construct = RG.UNSUPPORTED[name]
    got = _diagnosis(p_compile, PUnsupported, sql, PG.gate_catalog())
    want = _diagnosis(r_compile, RUnsupported, sql, RG.gate_catalog())
    assert got == want and got[0] == construct and got[1] >= 1


@pytest.mark.parametrize("construct,sql", FUZZ.UNSUPPORTED_SNIPPETS,
                         ids=[f"{i}-{c}" for i, (c, _) in
                              enumerate(FUZZ.UNSUPPORTED_SNIPPETS)])
def test_unsupported_construct_is_diagnosed_as_the_reference(construct, sql):
    from auron_tpu.sql import tpcds_catalog as r_catalog
    from auron_tpu_torch.sql import tpcds_catalog as p_catalog

    got = _diagnosis(p_compile, PUnsupported, sql, p_catalog())
    want = _diagnosis(r_compile, RUnsupported, sql, r_catalog())
    assert got == want and got[0] == construct and got[1] >= 1 and got[2] >= 1


def _uses(lq):
    return [(u.table, u.rid, u.replicated) for u in lq.tables]


@pytest.mark.parametrize("n_parts", [2, 4])
@pytest.mark.parametrize("name", list(CORPUS))
def test_lowered_plans_equal_the_reference_bytes(name, n_parts):
    got = p_compile(CORPUS[name], PG.gate_catalog(), n_parts=n_parts)
    want = r_compile(CORPUS[name], RG.gate_catalog(), n_parts=n_parts)
    assert got.distributed.SerializeToString() == \
        want.distributed.SerializeToString(deterministic=True)
    assert (got.collect is None) == (want.collect is None)
    if want.collect is not None:
        assert got.collect.SerializeToString() == \
            want.collect.SerializeToString(deterministic=True)
    assert [(f.name, str(f.dtype), f.nullable) for f in got.schema] == \
        [(f.name, str(f.dtype), f.nullable) for f in want.schema]
    assert (got.stage_schema is None) == (want.stage_schema is None)
    if want.stage_schema is not None:
        assert [(f.name, str(f.dtype)) for f in got.stage_schema] == \
            [(f.name, str(f.dtype)) for f in want.stage_schema]
    assert _uses(got) == _uses(want) and got.n_parts == want.n_parts == n_parts


@pytest.mark.parametrize("name", list(CORPUS))
def test_plan_text_equals_the_golden(name):
    lq = p_compile(CORPUS[name], PG.gate_catalog())
    with open(os.path.join(REPO, "tests", "goldens", "sql", f"{name}.txt")) as f:
        assert PG.plan_text(lq) == f.read()
    assert PG.check_golden(name, PG.plan_text(lq)) is None


def test_digests_and_plan_knobs_equal_the_reference():
    assert [o.key for o in PD.PLAN_KNOBS] == [o.key for o in RD.PLAN_KNOBS]
    assert [o.default for o in PD.PLAN_KNOBS] == [o.default for o in RD.PLAN_KNOBS]
    for sql in TEXTS.values():
        for fold in (True, False):
            assert PD.canonical_text(sql, fold) == RD.canonical_text(sql, fold)
            assert PD.plan_digest(sql, fold) == RD.plan_digest(sql, fold)


def test_corpus_is_the_reference_corpus():
    assert [(c.name, c.sql, c.verbatim, c.order, c.ascending, c.limit) for c in PG.CASES] == \
        [(c.name, c.sql, c.verbatim, c.order, c.ascending, c.limit) for c in RG.CASES]
    assert PG.UNSUPPORTED == RG.UNSUPPORTED
    assert len(PG.CASES) == 24 and len(PG.UNSUPPORTED) == 11
    assert PG.CANONICAL_FACT_ROWS == RG.CANONICAL_FACT_ROWS


@pytest.fixture(scope="module")
def catalog_frames():
    port = frames_of(p_build_tables(PT.generate(0.02, 42), seed=42))
    ref = r_build_tables(RT.generate(0.02, 42), seed=42)
    return port, ref


@pytest.mark.parametrize("table", list(TABLES))
def test_catalog_table_equals_the_reference_frame(catalog_frames, table):
    port, ref = catalog_frames
    pd.testing.assert_frame_equal(port[table], ref[table])
    if table == "store_sales":
        assert port[table]["ss_customer_sk"].isna().sum() > 0


def test_catalog_tables_carry_the_declared_schema():
    from auron_tpu_torch.sql.catalog import TABLES as P_TABLES
    from auron_tpu_torch.sql.catalog import schema_of

    def declared(tables):
        return [(t, [(n, str(d), nl) for n, d, nl in c]) for t, c in tables.items()]

    assert declared(P_TABLES) == declared(TABLES)
    tables = p_build_tables(PT.generate(0.005, 7), seed=7)
    for name, t in tables.items():
        assert t.schema == schema_of(name)
        assert list(t.columns) == [n for n, _, _ in P_TABLES[name]]
        assert set(t.valid) <= {n for n, _, nullable in P_TABLES[name] if nullable}


def test_compile_needs_no_jax_arrow_pandas_or_protobuf_and_no_card():
    """All 24 corpus texts compile to plan bytes with pyarrow, pandas,
    google.protobuf, JAX and the reference blocked, and lowering (which
    builds each aggregate through the planner) initializes no CUDA."""
    script = textwrap.dedent("""
        import sys
        for m in ("pyarrow", "pandas", "google.protobuf", "jax", "jaxlib", "auron_tpu"):
            sys.modules[m] = None  # any import of them raises ImportError
        import torch
        from auron_tpu_torch.models import sqlgate
        from auron_tpu_torch.sql import compile_text
        cat = sqlgate.gate_catalog()
        for case in sqlgate.CASES:
            lq = compile_text(case.sql, cat)
            assert lq.distributed.SerializeToString()
            assert sqlgate.check_golden(case.name, sqlgate.plan_text(lq)) is None, case.name
        assert len(sqlgate.run_unsupported(cat)) == 11
        assert not torch.cuda.is_initialized()
        print("OK", len(sqlgate.CASES))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "OK 24" in r.stdout, r.stdout + r.stderr
