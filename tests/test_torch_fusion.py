"""Whole-stage fusion of the port (``auron_tpu_torch/plan/fusion.py``)
against its eager operators and the JAX package's ``fuse_exec_tree``: the
counterparts of ``tests/test_fusion.py`` (chain bit-identity fuzz, agg
prefusion, dense re-anchor, a fused stage feeding a join chain that
mispredicts, blocking boundaries, unsafe expressions splitting segments,
the safety rules, the cost model, no new program on a replay, the metric
split, the probe prologue by join type with the existence LUT, a deferred
aggregate spilled mid-stream, the writer stage's byte-identical files), a
tree-parity case (the q42, q3 and q93 plans fuse into the same segments in
both packages on the CPU) and the capture-safety rule against the
reference's.

On the CPU a stage program runs eagerly; every program here runs under a
dispatch guard that fails on what a CUDA-graph capture refuses (a host
read, ``nonzero``, boolean-mask indexing, a tensor made from host data),
so the CPU run also checks that each program is capture-safe."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from auron_tpu import types as JT
from auron_tpu.exec import agg_exec as jagg
from auron_tpu.exec import basic as jbasic
from auron_tpu.exec import sort_exec as jsort
from auron_tpu.exec.base import ExecutionContext as JCtx
from auron_tpu.exec.joins import BroadcastHashJoinExec as JBHJ
from auron_tpu.exprs import ir as jir
from auron_tpu.ops.sortkeys import SortSpec as JSpec
from auron_tpu.plan import builders as B
from auron_tpu.plan import fusion as jfusion
from auron_tpu.plan import planner as jplanner
from auron_tpu.utils.config import Configuration as JConf
from auron_tpu.utils.config import conf_scope as jconf_scope

from auron_tpu_torch import types as PT
from auron_tpu_torch.exec import agg_exec as pagg
from auron_tpu_torch.exec import basic as pbasic
from auron_tpu_torch.exec import sort_exec as psort
from auron_tpu_torch.exec.base import ExecutionContext as PCtx
from auron_tpu_torch.exec.joins.bhj import BroadcastHashJoinExec as PBHJ
from auron_tpu_torch.exprs import ir as pir
from auron_tpu_torch.ops.sortkeys import SortSpec as PSpec
from auron_tpu_torch.plan import fusion as pfusion
from auron_tpu_torch.plan import planner as pplanner
from auron_tpu_torch.utils.config import Configuration as PConf
from torch_carry import canon, carry, jax_batch, rows

J = SimpleNamespace(T=JT, ir=jir, Filter=jbasic.FilterExec, Project=jbasic.ProjectExec,
                    Rename=jbasic.RenameColumnsExec, Scan=jbasic.MemoryScanExec,
                    Limit=jbasic.LimitExec, Agg=jagg.HashAggExec, AggExpr=jagg.AggExpr,
                    BHJ=JBHJ, Sort=jsort.SortExec, Spec=JSpec, fusion=jfusion, Conf=JConf)
P = SimpleNamespace(T=PT, ir=pir, Filter=pbasic.FilterExec, Project=pbasic.ProjectExec,
                    Rename=pbasic.RenameColumnsExec, Scan=pbasic.MemoryScanExec,
                    Limit=pbasic.LimitExec, Agg=pagg.HashAggExec, AggExpr=pagg.AggExpr,
                    BHJ=PBHJ, Sort=psort.SortExec, Spec=PSpec, fusion=pfusion, Conf=PConf)

ON = {"exec.fuse.enable": "on"}
OFF = {"exec.fuse.enable": "off", "exec.filter.fuse": "false"}


# ---------------------------------------------------------------------------
# the capture guard: what a CUDA-graph capture refuses fails here
# ---------------------------------------------------------------------------

_REFUSED = {"_local_scalar_dense", "nonzero", "masked_select", "lift_fresh",
            "lift_fresh_copy", "bincount", "_unique2", "unique_dim", "equal"}


class _CaptureGuard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in _REFUSED:
            raise AssertionError(f"stage program calls {func} (refused in a capture)")
        if name == "index" and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                                   for i in (args[1] or ())):
            raise AssertionError("stage program indexes by a boolean mask")
        return func(*args, **(kwargs or {}))


@pytest.fixture(autouse=True)
def capture_guard(monkeypatch):
    orig = pfusion._GraphCache.run

    def run(self, key, label, fn, batch_in, side_in, node):
        def guarded(b, s):
            with _CaptureGuard():
                return fn(b, s)
        return orig(self, key, label, guarded, batch_in, side_in, node)

    monkeypatch.setattr(pfusion._GraphCache, "run", run)


# ---------------------------------------------------------------------------
# helpers: one numpy input through both packages
# ---------------------------------------------------------------------------


def _frame(n, seed, nulls=False):
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(0, 50, n).astype(np.int64),
            "v": rng.integers(-4096, 4096, n) / 256.0,
            "q": rng.integers(0, 100, n).astype(np.int32),
            "s": np.array([f"s{int(x) % 9}" for x in rng.integers(0, 40, n)], dtype=object)}
    valid = None
    if nulls:
        idx = np.arange(n)
        valid = {"k": idx % 7 != 0, "v": idx % 5 != 0, "s": idx % 11 != 0}
    return jax_batch(cols, valid)


def _batches(frames):
    """(JAX batches, the same batches in the port)."""
    return list(frames), [carry(f) for f in frames]


def _types(op):
    out = [type(op).__name__]
    for c in op.children:
        out += _types(c)
    return out


def _walk(op):
    yield op
    for c in op.children:
        yield from _walk(c)


def _run_port(tree, conf: dict, fuse: bool = True):
    pc = PConf(dict(conf))
    if fuse:
        tree = pfusion.fuse_exec_tree(tree, pc, "cpu")
    ctx = PCtx(conf=pc, device="cpu")
    ctx.metrics.name = tree.name
    return tree, list(tree.execute(0, ctx)), ctx


def _run_jax(tree, conf: dict):
    jc = JConf(dict(conf))
    with jconf_scope(jc):
        tree = jfusion.fuse_exec_tree(tree, jc)
        return tree, list(tree.execute(0, JCtx(conf=jc)))


def _ab(build, conf: dict | None = None):
    """The port's tree fused and eager, and the JAX tree fused: equal rows.
    Returns the port's fused tree and its context."""
    conf = dict(conf or {})
    _, eager, _ = _run_port(build(P), {**conf, **OFF}, fuse=False)
    tree, fused, ctx = _run_port(build(P), {**conf, **ON})
    _, jax_out = _run_jax(build(J), {**conf, **ON})
    assert canon(rows(fused)) == canon(rows(eager))
    assert canon(rows(fused)) == canon(rows(jax_out))
    return tree, ctx


# ---------------------------------------------------------------------------
# bit identity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_chain_bit_identity_fuzz(seed, nulls):
    """filter -> project -> filter -> rename over several capacity buckets
    and NULL patterns, a dictionary column riding through."""
    rng = np.random.default_rng(seed * 101)
    jb, pb = _batches([_frame(int(rng.integers(100, 3000)), seed * 10 + i, nulls)
                       for i in range(4)])

    def build(m):
        ir, T = m.ir, m.T
        scan = m.Scan([list(jb if m is J else pb)], (jb if m is J else pb)[0].schema)
        f1 = m.Filter(scan, [ir.BinaryOp("gt", ir.Column(1, "v"), ir.Literal(-0.5, T.FLOAT64)),
                             ir.In(ir.Column(2, "q"), tuple(range(0, 90)), False)])
        p = m.Project(f1, [
            ir.BinaryOp("add", ir.Column(0, "k"), ir.Literal(1, T.INT64)),
            ir.Case(((ir.BinaryOp("lt", ir.Column(2, "q"), ir.Literal(10, T.INT32)),
                      ir.Literal(0.0, T.FLOAT64)),), ir.Column(1, "v")),
            ir.Column(3, "s"),
            ir.Not(ir.IsNull(ir.Column(0, "k"))),
        ], ["k1", "vc", "s", "kn"])
        f2 = m.Filter(p, [ir.Column(3, "kn")])
        return m.Rename(f2, ["K", "V", "S", "KN"])

    tree, ctx = _ab(build)
    assert isinstance(tree, pfusion.FusedStageExec), _types(tree)
    assert tree.fused_op_names() == ["FilterExec", "ProjectExec", "FilterExec"]
    assert ctx.metrics.values["fused_batches"] == 4


def _agg_specs(m, partial: bool):
    ir = m.ir
    if partial:
        cols = [("sum", 1, "s"), ("count_star", None, "c"), ("min", 2, "lo"),
                ("max", 1, "hi"), ("avg", 1, "a"), ("count", 1, "cv")]
    else:
        cols = [("sum", 1, "s"), ("count_star", None, "c"), ("min", 2, "lo"),
                ("max", 3, "hi"), ("avg", 4, "a"), ("count", 6, "cv")]
    return [(m.AggExpr(f, None if c is None else ir.Column(c, "x")), n) for f, c, n in cols]


@pytest.mark.parametrize("seed", [0, 1])
def test_agg_prefusion_bit_identity(seed):
    """scan -> filter -> partial agg -> final agg with the grouping and
    argument expressions in the stage program and the dense fold's prep
    handed over: identical to the eager pipeline and the reference."""
    jb, pb = _batches([_frame(1500, seed * 7 + i, nulls=True) for i in range(5)])

    def build(m):
        ir, T = m.ir, m.T
        src = jb if m is J else pb
        f = m.Filter(m.Scan([list(src)], src[0].schema),
                     [ir.BinaryOp("gt", ir.Column(2, "q"), ir.Literal(20, T.INT32))])
        key = ir.If(ir.BinaryOp("lt", ir.Column(2, "q"), ir.Literal(60, T.INT32)),
                    ir.Literal(None, T.INT64), ir.Column(0, "k"))
        p = m.Agg(f, [(key, "g")], _agg_specs(m, True), "partial")
        return m.Agg(p, [(ir.Column(0, "g"), "g")], _agg_specs(m, False), "final")

    tree, ctx = _ab(build)
    partial = tree.children[0]
    assert isinstance(partial, pagg.HashAggExec)
    stage = partial.children[0]
    assert isinstance(stage, pfusion.FusedStageExec) and stage.dense_link is not None
    assert all(isinstance(g, pir.Column) for g, _ in partial.groupings)
    assert ctx.metrics.child(0).child(0).values.get("fused_batches", 0) == 5


def test_dense_reanchor_under_prefusion():
    """The key range jumps mid-stream: the dense table drains, re-anchors and
    re-publishes; batches prepped under a stale anchor fold eagerly."""
    frames = []
    for i in range(6):
        lo = 0 if i < 2 else 10_000_000 * i
        k = (np.arange(800) % 37 + lo).astype(np.int64)
        frames.append(jax_batch({"k": k, "v": np.arange(800) / 64.0}))
    jb, pb = _batches(frames)

    def build(m):
        ir = m.ir
        src = jb if m is J else pb
        aggs = [(m.AggExpr("sum", ir.Column(1, "v")), "s"), (m.AggExpr("count_star", None), "c")]
        p = m.Agg(m.Scan([list(src)], src[0].schema), [(ir.Column(0, "k"), "k")], aggs,
                  "partial")
        return m.Agg(p, [(ir.Column(0, "k"), "k")],
                     [(m.AggExpr("sum", ir.Column(1, "s")), "s"),
                      (m.AggExpr("count_star", None), "c")], "final")

    tree, ctx = _ab(build)
    stage = tree.children[0].children[0]
    assert isinstance(stage, pfusion.FusedStageExec) and stage.dense_link is not None


def test_fused_stage_feeding_join_chain_mispredict():
    """A fused filter below a unique BHJ whose selectivity jumps ~0 to ~100 %
    mid-stream: the predicted compaction's mispredict repair sees the
    batches the eager filter would emit."""
    n = 6000
    k0 = np.where(np.arange(n) < 1000, 999, np.arange(n) % 8).astype(np.int64)
    fact = [jax_batch({"k0": k0[i:i + 1000], "amt": np.arange(i, i + 1000, dtype=np.int64)})
            for i in range(0, n, 1000)]
    dim = [jax_batch({"id": np.arange(8, dtype=np.int64),
                      "dv": np.arange(8, dtype=np.int64) * 10})]
    jf, pf = _batches(fact)
    jd, pd_ = _batches(dim)

    def build(m):
        ir, T = m.ir, m.T
        f, d = (jf, jd) if m is J else (pf, pd_)
        flt = m.Filter(m.Scan([list(f)], f[0].schema),
                       [ir.BinaryOp("gteq", ir.Column(1, "amt"), ir.Literal(0, T.INT64))])
        return m.BHJ(flt, m.Scan([list(d)], d[0].schema), [ir.Column(0, "k0")],
                     [ir.Column(0, "id")], "inner", build_side="right")

    tree, ctx = _ab(build, {"join.compact.output": "on"})
    assert "FusedStageExec" in _types(tree)
    snap = ctx.metrics.snapshot()
    assert snap["values"].get("sel_mispredicts", 0) > 0
    assert snap["values"].get("probe_prep_batches", 0) > 0


# ---------------------------------------------------------------------------
# boundaries, safety, cost model
# ---------------------------------------------------------------------------


def test_segments_never_cross_blocking_boundaries():
    jb, pb = _batches([_frame(500, 3)])

    def build(m):
        ir, T = m.ir, m.T
        src = jb if m is J else pb
        f1 = m.Filter(m.Scan([list(src)], src[0].schema),
                      [ir.BinaryOp("gt", ir.Column(1, "v"), ir.Literal(0.0, T.FLOAT64))])
        srt = m.Sort(f1, [ir.Column(0, "k")], [m.Spec(True, True)])
        f2 = m.Filter(srt, [ir.BinaryOp("lt", ir.Column(2, "q"), ir.Literal(90, T.INT32))])
        return m.Project(m.Limit(f2, 100), [ir.Column(0, "k"), ir.Column(1, "v")], ["k", "v"])

    tree = pfusion.fuse_exec_tree(build(P), PConf(ON), "cpu")
    names = _types(tree)
    assert names.count("FusedStageExec") == 3
    assert names.index("LimitExec") < names.index("SortExec")
    for seg in (s for s in _walk(tree) if isinstance(s, pfusion.FusedStageExec)):
        assert len(seg.fused_op_names()) == 1
    jtree = jfusion.fuse_exec_tree(build(J), JConf(ON))
    assert _types(jtree) == names


def test_unsafe_exprs_split_segments():
    """LIKE over a dictionary column splits the chain: the safe runs around
    it fuse, the unsafe operator stays eager (counted by reason)."""
    jb, pb = _batches([_frame(400, 4)])

    def build(m):
        ir, T = m.ir, m.T
        src = jb if m is J else pb
        f1 = m.Filter(m.Scan([list(src)], src[0].schema),
                      [ir.BinaryOp("gt", ir.Column(1, "v"), ir.Literal(-9.0, T.FLOAT64))])
        f2 = m.Filter(f1, [ir.Like(ir.Column(3, "s"), "s1%", False, "\\")])
        return m.Filter(f2, [ir.BinaryOp("lt", ir.Column(2, "q"), ir.Literal(95, T.INT32))])

    pfusion.reset_fusion_stats()
    tree, _ = _ab(build)
    assert _types(tree)[:4] == ["FusedStageExec", "FilterExec", "FusedStageExec",
                                "MemoryScanExec"]
    assert pfusion.fusion_stats()["eager"].get("unsafe", 0) >= 1
    assert tree._fusion_plan == {"segments": 2, "eager": {"unsafe": 1}}


def _safety_corpus(m):
    ir, T = m.ir, m.T
    c = ir.Column
    return [
        (ir.BinaryOp("gt", c(1, "v"), ir.Literal(0.0, T.FLOAT64)), False),
        (ir.In(c(2, "q"), (1, 2, 3), True), False),
        (c(3, "s"), False), (c(3, "s"), True),
        (ir.IsNull(c(3, "s")), False), (ir.IsNotNull(c(3, "s")), False),
        (ir.BinaryOp("eq", c(3, "s"), ir.Literal("s1", T.STRING)), False),
        (ir.Like(c(3, "s"), "s%", False, "\\"), False),
        (ir.RowNum(), False), (ir.MonotonicId(), False), (ir.SparkPartitionId(), False),
        (ir.Cast(c(0, "k"), T.FLOAT64), False),
        (ir.Cast(c(0, "k"), T.STRING), True),
        (ir.Cast(c(1, "v"), T.decimal(12, 2)), False),
        (ir.BinaryOp("mul", ir.Cast(c(0, "k"), T.decimal(10, 2)),
                     ir.Literal(3, T.decimal(4, 1))), False),
        (ir.BinaryOp("div", c(0, "k"), ir.Literal(0, T.INT64)), False),
        (ir.BinaryOp("mod", c(2, "q"), ir.Literal(7, T.INT32)), False),
        (ir.Coalesce((c(0, "k"), ir.Literal(5, T.INT64))), False),
        (ir.Case(((ir.IsNull(c(0, "k")), ir.Literal("x", T.STRING)),), c(3, "s")), True),
        (ir.If(ir.Not(ir.IsNull(c(1, "v"))), c(1, "v"), ir.Literal(None, T.FLOAT64)), False),
        (ir.Literal(None, T.NULL), False),
        # scalar functions (not among the reference's fusable nodes) and the
        # LIST values they make
        (ir.ScalarFunc("abs", (c(0, "k"),)), False),
        (ir.ScalarFunc("abs", (c(0, "k"),)), True),
        # host callbacks (bridge/udf.py): a host UDF never enters a stage
        (ir.HostUDF("f", (c(0, "k"),), T.INT64), False),
        (ir.HostUDF("f", (c(3, "s"),), T.STRING), True),
        (ir.BinaryOp("add", ir.HostUDF("f", (c(0, "k"),), T.INT64), c(0, "k")), False),
        (ir.IsNotNull(ir.HostUDF("f", (c(1, "v"),), T.FLOAT64)), False),
        (ir.ScalarFunc("upper", (c(3, "s"),)), True),
        (ir.ScalarFunc("split", (c(3, "s"), ir.Literal(",", T.STRING))), True),
        (ir.IsNull(ir.ScalarFunc("split", (c(3, "s"), ir.Literal(",", T.STRING)))), False),
        (ir.BinaryOp("gt", ir.ScalarFunc("xxhash64", (c(0, "k"),)), ir.Literal(0, T.INT64)),
         False),
        (ir.Coalesce((ir.ScalarFunc("year", (c(2, "q"),)), ir.Literal(1, T.INT32))), False),
    ]


def _list_schema(m):
    T = m.T
    return T.Schema((T.Field("k", T.INT64), T.Field("l", T.DataType(T.TypeKind.LIST,
                                                                     inner=(T.STRING,)))))


def _list_corpus(m):
    """Bare LIST columns and expressions over them."""
    ir = m.ir
    lcol = ir.Column(1, "l")
    return [(lcol, False), (lcol, True), (ir.IsNull(lcol), False), (ir.IsNotNull(lcol), True),
            (ir.ScalarFunc("array_size", (lcol,)), False),
            (ir.ScalarFunc("array_reverse", (lcol,)), True)]


def test_safety_rules_equal_the_reference():
    """The port's ``expr_capture_safe`` refuses exactly what the reference's
    ``expr_trace_safe`` refuses: every expression the reference fuses
    evaluates through device-only ops in the port, so the capture rule adds
    no refusal (ROADMAP Queue 3); the capture guard of this file holds the
    programs to it."""
    jschema = _frame(10, 0).schema
    pschema = carry(_frame(10, 0)).schema
    for (je, jdo), (pe, pdo) in zip(_safety_corpus(J), _safety_corpus(P)):
        want = jfusion.expr_trace_safe(je, jschema, allow_dict_out=jdo)
        assert pfusion.expr_capture_safe(pe, pschema, allow_dict_out=pdo) == want, pe
    jls, pls = _list_schema(J), _list_schema(P)
    for (je, jdo), (pe, pdo) in zip(_list_corpus(J), _list_corpus(P)):
        want = jfusion.expr_trace_safe(je, jls, allow_dict_out=jdo)
        assert pfusion.expr_capture_safe(pe, pls, allow_dict_out=pdo) == want, pe
    assert not pfusion.expr_capture_safe(pir.ScalarFunc("abs", (pir.Column(0, "k"),)), pschema)
    assert not pfusion.expr_capture_safe(pir.Column(3, "s"), pschema)
    assert pfusion.expr_capture_safe(pir.IsNull(pir.Column(3, "s")), pschema)


def test_cost_model_substrate_selection():
    """auto on the CPU fuses only segments whose eager dispatch estimate
    reaches exec.fuse.min.ops; on CUDA it fuses every safe segment; on and
    off override."""
    pb = [carry(_frame(200, 5))]

    def build():
        return pbasic.ProjectExec(pbasic.MemoryScanExec([list(pb)], pb[0].schema),
                                  [pir.Column(0, "k")], ["k"])

    fuse = pfusion.fuse_exec_tree
    auto = {"exec.fuse.enable": "auto"}
    assert not isinstance(fuse(build(), PConf({**auto, "exec.fuse.min.ops": 50}), "cpu"),
                          pfusion.FusedStageExec)
    assert isinstance(fuse(build(), PConf({**auto, "exec.fuse.min.ops": 1}), "cpu"),
                      pfusion.FusedStageExec)
    assert isinstance(fuse(build(), PConf({**auto, "exec.fuse.min.ops": 50}), "cuda"),
                      pfusion.FusedStageExec)
    assert not isinstance(fuse(build(), PConf({"exec.fuse.enable": "off"}), "cuda"),
                          pfusion.FusedStageExec)


def test_cuda_defaults_resolve_on():
    """Every on|off|auto key of the slice resolves on for CUDA tensors, the
    bool keys default to true; on the CPU the incremental keys stay off."""
    from auron_tpu_torch.utils import config as C

    conf = PConf()
    for opt in (C.FUSE_ENABLE, C.FUSE_PROBE, C.FUSE_SHUFFLE, C.AGG_INCREMENTAL_PROBE,
                C.AGG_INCREMENTAL_MERGEPATH):
        assert conf.get(opt) == "auto"
        assert pfusion._should_fuse(0, conf, "cuda", opt)
    assert conf.get(C.FILTER_FUSE) and conf.get(C.FUSE_AGG_INPUTS)
    assert conf.get(C.FUSE_MIN_OPS) == 2
    agg = pagg.HashAggExec(pbasic.EmptyPartitionsExec(carry(_frame(4, 0)).schema, 1),
                           [(pir.Column(0, "k"), "k")],
                           [(pagg.AggExpr("sum", pir.Column(1, "v")), "s")], "partial")
    assert agg._probe_eligible(conf, "cuda") and agg._mergepath_eligible(conf, "cuda")
    assert not agg._probe_eligible(conf, "cpu") and not agg._mergepath_eligible(conf, "cpu")


# ---------------------------------------------------------------------------
# programs and metrics
# ---------------------------------------------------------------------------


def test_replay_adds_no_programs():
    """The program key is stable: replaying a stream, or the same segment in
    a fresh tree, adds no program and no capacity bucket."""
    pb = [carry(f) for f in (_frame(100, 6), _frame(1000, 7), _frame(100, 8))]

    def build():
        return pbasic.FilterExec(pbasic.MemoryScanExec([list(pb)], pb[0].schema),
                                 [pir.BinaryOp("gt", pir.Column(1, "v"),
                                               pir.Literal(0.0, PT.FLOAT64))])

    pfusion.reset_fusion_stats()
    _run_port(build(), ON)
    s1 = pfusion.fusion_stats()
    assert s1["programs"] == 1 and s1["buckets"] == 2 and s1["eager_runs"] == 3
    _run_port(build(), ON)
    s2 = pfusion.fusion_stats()
    assert (s2["programs"], s2["buckets"]) == (s1["programs"], s1["buckets"])


def test_metric_attribution_splits_per_operator():
    """The program's wall lands on the constituent operators' nodes; the
    stage keeps the rest, and the two add up to the stage's wall exactly."""
    pb = [carry(_frame(2000, 9))]
    tree = pbasic.ProjectExec(
        pbasic.FilterExec(pbasic.MemoryScanExec([list(pb)], pb[0].schema),
                          [pir.BinaryOp("gt", pir.Column(1, "v"), pir.Literal(0.0, PT.FLOAT64))]),
        [pir.BinaryOp("add", pir.Column(0, "k"), pir.Literal(1, PT.INT64))], ["k1"])
    tree, _, ctx = _run_port(tree, ON)
    snap = ctx.metrics.snapshot()
    parts = {c["name"]: c["values"].get("elapsed_compute", 0) for c in snap["children"][1:]}
    assert set(parts) == {"FilterExec", "ProjectExec"} and sum(parts.values()) > 0
    stage = snap["values"]
    assert stage["fused_batches"] == 1
    assert sum(parts.values()) + stage["elapsed_compute"] == stage["stage_wall"]


# ---------------------------------------------------------------------------
# the probe prologue and the writer stage
# ---------------------------------------------------------------------------


def _probe_frames(seed, n=6000, jump=False):
    rng = np.random.default_rng(seed)
    k = rng.integers(1, 200, n).astype(np.int64)
    if jump:
        k[: n // 3] = 10_000  # outside the build's keys: no matches
    valid = np.arange(n) % 7 != 0  # NULL keys never join
    v = rng.integers(-4096, 4096, n) / 256.0
    return [jax_batch({"k": k[i:i + 1000], "v": v[i:i + 1000]}, {"k": valid[i:i + 1000]})
            for i in range(0, n, 1000)]


def _probe_tree(m, probe, dim, join_type):
    ir, T = m.ir, m.T
    flt = m.Filter(m.Scan([list(probe)], probe[0].schema),
                   [ir.BinaryOp("gt", ir.Column(1, "v"), ir.Literal(-10.0, T.FLOAT64))])
    return m.BHJ(flt, m.Scan([list(dim)], dim[0].schema), [ir.Column(0, "k")],
                 [ir.Column(0, "id")], join_type, build_side="right")


@pytest.mark.parametrize("jump", [False, True], ids=["steady", "mispredict"])
@pytest.mark.parametrize("join_type", ["inner", "left", "left_semi", "left_anti", "existence"])
def test_probe_prologue_bit_identity(join_type, jump):
    """Key evaluation, the unique lookup and the gather or compact-take in
    the stage program: equal to the eager prologue and the reference, through
    the predicted compaction and its mispredict repair."""
    jp, pp = _batches(_probe_frames(3, jump=jump))
    jd, pd_ = _batches([jax_batch({"id": np.arange(1, 101, dtype=np.int64),
                                   "b": np.arange(1, 101) * 2.0})])
    pfusion.reset_fusion_stats()
    tree, ctx = _ab(lambda m: _probe_tree(m, jp if m is J else pp, jd if m is J else pd_,
                                          join_type))
    assert pfusion.fusion_stats()["probe_segments"] >= 1
    snap = ctx.metrics.snapshot()
    assert snap["values"].get("probe_prep_batches", 0) > 0, snap["values"]
    if jump and join_type == "inner":
        assert snap["values"].get("sel_mispredicts", 0) > 0


@pytest.mark.parametrize("join_type", ["left_semi", "left_anti"])
def test_probe_prologue_exists_lut_bit_identity(join_type):
    """A duplicate-keyed build probed for existence: the existence-LUT probe
    runs in the stage program (payload kind "exists")."""
    jp, pp = _batches(_probe_frames(5))
    jd, pd_ = _batches([jax_batch({"id": np.tile(np.arange(1, 51, dtype=np.int64), 3),
                                   "b": np.arange(150) * 1.0})])
    tree, ctx = _ab(lambda m: _probe_tree(m, jp if m is J else pp, jd if m is J else pd_,
                                          join_type))
    stage = tree.children[0]
    assert isinstance(stage, pfusion.FusedStageExec) and stage.probe_link is not None
    assert ctx.metrics.snapshot()["values"].get("probe_prep_batches", 0) > 0


def test_fused_probe_deferred_agg_spill_midstream():
    """The q93 shape under memory pressure: a fused probe prologue (left
    join, NULL-heavy keys) feeding a bool-key partial aggregate on the
    deferred-count path, a tiny budget spilling its table mid-stream:
    counts exact, sums at rel 1e-9, fused and eager."""
    from auron_tpu_torch.memory.memmgr import MemManager

    pp = [carry(b) for b in _probe_frames(11, n=12000, jump=True)]
    pd_ = [carry(jax_batch({"id": np.arange(1, 101, dtype=np.int64),
                            "b": np.arange(1, 101) * 2.0}))]

    def build():
        j = pbasic.MemoryScanExec([list(pd_)], pd_[0].schema)
        join = PBHJ(pbasic.MemoryScanExec([list(pp)], pp[0].schema), j, [pir.Column(0, "k")],
                    [pir.Column(0, "id")], "left", build_side="right")
        p = pagg.HashAggExec(join, [(pir.IsNull(pir.Column(0, "k")), "k_null")],
                             [(pagg.AggExpr("count_star", None), "rows"),
                              (pagg.AggExpr("sum", pir.Column(1, "v")), "s")], "partial")
        return pagg.HashAggExec(p, [(pir.Column(0, "k_null"), "k_null")],
                                [(pagg.AggExpr("count_star", None), "rows"),
                                 (pagg.AggExpr("sum", pir.Column(1, "s")), "s")], "final")

    MemManager.init(budget_bytes=64 << 10)
    try:
        _, eager, _ = _run_port(build(), {**OFF, "exec.agg.partial.defer": "off"}, fuse=False)
        _, fused, ctx = _run_port(build(), {**ON, "exec.agg.partial.defer": "on"})
    finally:
        MemManager.init()
    e, f = canon(rows(eager)), canon(rows(fused))
    assert [r[:2] for r in e] == [r[:2] for r in f]
    for a, b in zip(e, f):
        assert a[2] == pytest.approx(b[2], rel=1e-9)


@pytest.mark.parametrize("part", ["hash", "rr"])
def test_writer_stage_counted_and_byte_identical(tmp_path, part):
    """Partition ids and the pid clustering in the stage program: the shuffle
    files are byte-identical to the eager writer's."""
    from auron_tpu_torch.exec.shuffle.partitioning import (
        HashPartitioning, RoundRobinPartitioning,
    )
    from auron_tpu_torch.exec.shuffle.writer import ShuffleWriterExec

    pb = [carry(_frame(2000, s)) for s in (1, 2, 3)]

    def run(conf, d):
        scan = pbasic.MemoryScanExec([list(pb)], pb[0].schema)
        prj = pbasic.ProjectExec(scan, [pir.Column(0, "k"), pir.Column(1, "v")], ["k", "v"])
        mk = (HashPartitioning([pir.Column(0, "k")], 3) if part == "hash"
              else RoundRobinPartitioning(3))
        w = ShuffleWriterExec(prj, mk, str(d / "x.data"), str(d / "x.index"))
        _run_port(w, conf, fuse=conf is ON)
        return (d / "x.data").read_bytes(), (d / "x.index").read_bytes()

    d_on, d_off = tmp_path / "on", tmp_path / "off"
    d_on.mkdir(), d_off.mkdir()
    pfusion.reset_fusion_stats()
    on_data, on_idx = run(ON, d_on)
    assert pfusion.fusion_stats()["writer_segments"] >= 1
    off_data, off_idx = run(OFF, d_off)
    # the trailing 16 bytes carry a random attempt pair tag
    assert on_data[:-16] == off_data[:-16]
    assert len(on_idx) == len(off_idx)


# ---------------------------------------------------------------------------
# tree parity with the reference on the q42, q3 and q93 plans
# ---------------------------------------------------------------------------


def _schemas():
    from auron_tpu.models import tpcds as jt

    d = jt.generate(0.001, 1)
    return (jt._schema_of(d.store_sales), jt._schema_of(d.date_dim), jt._schema_of(d.item))


def _q42_proto():
    ss, _, it = _schemas()
    c = jir.col
    j = B.hash_join(B.memory_scan(ss, "q42_fact"), B.memory_scan(it, "q42_item"), [c(1)],
                    [c(0)], "inner", build_side="right")
    pr = B.project(j, [(c(6), "brand"), (c(4), "p")])
    p = B.hash_agg(pr, [(c(0), "brand")], [("sum", c(1), "rev")], "partial")
    f = B.hash_agg(p, [(c(0), "brand")], [("sum", c(1), "rev")], "final")
    return B.sort(f, [(c(1), JSpec(asc=False)), (c(0), JSpec())], fetch=10)


def _q3_map_proto():
    ss, dd, it = _schemas()
    c, lit = jir.col, jir.lit
    dscan = B.filter_(B.memory_scan(dd, "q3_dd"), [jir.BinaryOp("eq", c(2), lit(11))])
    iscan = B.filter_(B.memory_scan(it, "q3_item"), [jir.BinaryOp("eq", c(2), lit(1))])
    j1 = B.hash_join(B.memory_scan(ss, "q3_fact"), dscan, [c(0)], [c(0)], "inner",
                     build_side="right")
    j2 = B.hash_join(j1, iscan, [c(1)], [c(0)], "inner", build_side="right")
    proj = B.project(j2, [(c(6), "d_year"), (c(9), "i_brand_id"), (c(4), "price")])
    agg = B.hash_agg(proj, [(c(0), "d_year"), (c(1), "i_brand_id")], [("sum", c(2), "s")],
                     "partial")
    return B.shuffle_writer(agg, B.hash_partitioning([c(0), c(1)], 4), "/x.data", "/x.index")


def _q93_map_proto():
    ss, _, _ = _schemas()
    c = jir.col
    key = jir.If(jir.BinaryOp("lt", c(3), jir.Literal(85, JT.INT32)),
                 jir.Literal(None, JT.INT64), c(2))
    proj = B.project(B.memory_scan(ss, "q93_fact"), [(key, "k"), (c(4), "price")])
    return B.shuffle_writer(proj, B.hash_partitioning([c(0)], 4), "/x.data", "/x.index")


def _q93_reduce_proto():
    c = jir.col
    inter = JT.Schema((JT.Field("k", JT.INT64, True), JT.Field("price", JT.FLOAT64, True)))
    cu = JT.Schema((JT.Field("c_customer_sk", JT.INT64, True),
                    JT.Field("c_band", JT.INT64, True)))
    j = B.hash_join(B.ipc_reader(inter, "q93_ex0"), B.memory_scan(cu, "q93_cust"), [c(0)],
                    [c(0)], "left", build_side="right")
    p = B.hash_agg(j, [(jir.IsNull(c(0)), "k_null")],
                   [("count_star", None, "rows"), ("count", c(2), "matched"),
                    ("sum", c(1), "s")], "partial")
    return B.hash_agg(p, [(c(0), "k_null")], [("count_star", None, "rows"),
                                              ("count", c(1), "matched"), ("sum", c(2), "s")],
                      "final")


def _segments(op) -> list:
    """Operator names in walk order; for a fused stage its constituents,
    step kinds and expressions, and which extension it carries."""
    out = []
    for o in _walk(op):
        if type(o).__name__ != "FusedStageExec":
            out.append(type(o).__name__)
            continue
        probe = getattr(o, "_probe_keys", None)
        probe = probe if probe is not None else (o._probe_cfg[0] if o._probe_cfg else ())
        shuffle = o.shuffle[0] if o.shuffle is not None else None
        out.append(("FusedStageExec", tuple(o.fused_op_names()),
                    tuple((k, repr(list(ex))) for k, _, ex in o.steps),
                    repr(list(probe)), repr(shuffle), o.dense_link is not None))
    return out


@pytest.mark.parametrize("plan", ["q42", "q3", "q93_map", "q93_reduce"])
@pytest.mark.parametrize("conf", [{}, {"exec.fuse.min.ops": 12}, ON, OFF])
def test_fused_tree_equals_reference(plan, conf):
    """The same task proto and conf through both packages' ``task_from_proto``
    on the CPU: the same segments (operator names, steps, extensions)."""
    proto = {"q42": _q42_proto, "q3": _q3_map_proto, "q93_map": _q93_map_proto,
             "q93_reduce": _q93_reduce_proto}[plan]()
    task = B.task(proto, conf={k: v for k, v in conf.items() if k != "exec.filter.fuse"})
    want, *_ = jplanner.task_from_proto(task)
    got, *_ = pplanner.task_from_proto(pplanner.decode_task(task.SerializeToString()), "cpu")
    assert _segments(got) == _segments(want)
    if conf in ({}, ON):
        assert any(isinstance(o, pfusion.FusedStageExec) for o in _walk(got))


# ---------------------------------------------------------------------------
# the graph cache's bookkeeping, with torch.cuda's graph calls stubbed
# ---------------------------------------------------------------------------


class _FakeGraph:
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


#: bytes of the segments a stubbed capture allocates in its private pool
_FAKE_POOL_BYTES = 3 << 20


def _stub_cuda(monkeypatch, fail: bool):
    import contextlib
    import itertools

    pools = []
    ids = itertools.count(1)

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode=None):
        assert capture_error_mode == "thread_local" and pool is not None
        pools.append(pool)  # every capture has a private pool of its own
        yield
        if fail:
            raise RuntimeError("operation not permitted when stream is capturing")

    def snapshot():
        return ([{"segment_pool_id": (0, 0), "total_size": 1 << 30}]  # the general pool
                + [{"segment_pool_id": p, "total_size": _FAKE_POOL_BYTES} for p in pools])

    class _Stream:  # replays order themselves by an event on the current stream
        waited = []

        def wait_event(self, e):
            self.waited.append(e)

    class _Event:
        def record(self, stream=None):
            pass

    for name, fn in (("synchronize", lambda *a: None), ("memory_snapshot", snapshot),
                     ("graph_pool_handle", lambda: (0, next(ids))),
                     ("CUDAGraph", _FakeGraph), ("graph", graph),
                     ("current_stream", lambda *a: _Stream()), ("Event", _Event)):
        monkeypatch.setattr(torch.cuda, name, fn)
    return pools


@pytest.mark.parametrize("fail", [False, True])
def test_capture_counts_launches_per_replay_and_raises_on_failure(monkeypatch, fail):
    """A capture records each kernel counter's delta and gives it back (it
    launches nothing); every replay adds it and returns clones of the
    graph's outputs. A capture that fails raises StageCaptureError naming
    the stage, with the counters restored; nothing runs it eagerly."""
    from auron_tpu_torch.ops import partition_kernels as pk

    _stub_cuda(monkeypatch, fail)
    before = dict(pk.LAUNCHES)

    from auron_tpu_torch.ops import launch_count

    def fn(batch_in, side_in):
        # what the K1 wrapper does at a launch
        launch_count.add(pk.LAUNCHES, pk._launch_lock, "murmur3_pmod")
        return (batch_in[0] + side_in[0],)

    x, side = torch.arange(4), torch.tensor([10])
    cache = pfusion._GraphCache()
    if fail:
        with pytest.raises(pfusion.StageCaptureError, match="capture of fused stage test"):
            cache._capture("test", fn, (x,), (side,))
        assert pk.LAUNCHES == before
        return
    g = cache._capture("test", fn, (x,), (side,))
    assert pk.LAUNCHES == before and g.tally[0] == {"murmur3_pmod": 1}
    out = g.replay((torch.arange(4) * 2,), (side,))
    assert pk.LAUNCHES["murmur3_pmod"] == before["murmur3_pmod"] + 1
    assert out[0].tolist() == [10, 11, 12, 13]  # the fake graph does not recompute
    assert out[0] is not g.static_out[0]  # a clone: later replays cannot overwrite it
    assert g.static_in[0].tolist() == [0, 2, 4, 6]  # the batch was copied in
    pk.LAUNCHES.update(before)


def test_graph_cache_stays_bounded_over_distinct_builds(monkeypatch):
    """Graphs of many distinct builds (a key each) under a cap: the cache
    keeps at most the cap (the newest graph always stays), drops the least
    recently replayed first, counts each graph's private pool and static
    inputs once, and holds no build alive. It is one spillable consumer of
    the memory manager: another consumer's acquire spills it, dropping
    every graph."""
    import gc
    import weakref

    from auron_tpu_torch.memory.memmgr import MemManager

    pools = _stub_cuda(monkeypatch, False)
    cache = pfusion._GraphCache()
    x = torch.arange(1024)  # 8 KiB static input
    per_graph = _FAKE_POOL_BYTES + 8192 + 4096  # pool, batch input, build side
    cap = 3 * per_graph
    seen = []
    for i in range(10):
        build = torch.full((512,), i)  # this build's LUT
        g = cache._capture(f"build {i}", lambda b, s: (b[0] + s[0][0],), (x,), (build,))
        assert g.nbytes == per_graph
        cache._admit(("probe", i), g, cap)
        seen.append(weakref.ref(build))
        if i == 4:  # a replay of build 2's graph makes it the most recent
            cache._graphs.move_to_end(("probe", 2))
        assert cache.pool_bytes() <= cap and len(cache._graphs) <= 3
        del build, g
    gc.collect()
    assert len(pools) == 10 and all(r() is None for r in seen)  # no build pinned
    assert list(cache._graphs) == [("probe", 7), ("probe", 8), ("probe", 9)]
    assert pfusion.fusion_stats()["pool_bytes"] == cache.pool_bytes() == cap
    big = cache._capture("big", lambda b, s: (b[0],), (torch.arange(1 << 20),), ())
    cache._admit(("big",), big, cap)  # past the cap alone: it stays, the rest go
    assert list(cache._graphs) == [("big",)] and cache.pool_bytes() == big.nbytes > cap

    class Sorter:
        name = "sorter"

        def __init__(self):
            self.spills = 0

        def mem_used(self):
            return 0

        def spill(self):
            self.spills += 1
            return 0

    try:
        mm = MemManager.init(budget_bytes=16 << 20)
        assert cache._register() is mm and cache._register() is mm
        assert mm.total_used() == cache.pool_bytes()  # registered once
        sorter = Sorter()
        mm.register(sorter)
        evicted = pfusion.fusion_stats()["evictions"]
        mm.acquire(sorter, 15 << 20)  # no room: the graph cache spills first
        assert cache.pool_bytes() == 0 and not cache._graphs and mm.total_used() == 0
        assert pfusion.fusion_stats()["evictions"] == evicted + 1
        assert sorter.spills == 0 and mm.num_spills == 1
    finally:
        MemManager.init()
