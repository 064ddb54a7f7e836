"""The fused segments of every class's plan (whole-stage fusion on, SF
0.005, the CPU): the planner's tree of the reference function's plan,
summed over the class's tasks (``stats["fusion"]``), and the segments left
eager with their reason. q17 fuses one segment, above its second join: the
reference's plan sorts each sort-merge join input whole, with no
projection below the sort to fuse; q41's and q9's one unsafe segment is a
LIKE over a dictionary and a scalar subquery."""

import pytest

from auron_tpu_torch.models import tpcds

#: class -> fused segments (``EAGER``: the segments left eager, by reason)
SEGMENTS = {
    "q1": 12, "q2": 5, "q4": 4, "q5": 16, "q6": 8, "q11": 5, "q14": 20, "q14b": 11, "q15": 3,
    "q16": 6, "q17": 1, "q18": 12, "q22": 3, "q23": 2, "q31": 4, "q33": 4, "q34": 2, "q37": 3,
    "q38": 11, "q41": 1, "q46": 3, "q48": 4, "q51": 2, "q54": 3, "q58": 10, "q65": 24, "q67": 1,
    "q67b": 1, "q72": 12, "q79": 3, "q85": 1, "q88": 4, "q9": 2, "q95": 32, "q99": 2, "q9b": 1,
    "windowed": 1, "windowed2": 0, "windowed_decimal": 1, "q3_decimal": 20,
    "q42_decimal": 2, "generate": 1, "tag_revenue": 2, "probe_agg": 1,
}
EAGER = {"q41": {"unsafe": 1}, "q9": {"unsafe": 1}}


@pytest.fixture(scope="module")
def data():
    return tpcds.generate(0.005, 42)


@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_fused_segments_per_class(data, name):
    stats: dict = {}
    getattr(tpcds, f"run_{name}_class")(data, device="cpu", conf={"exec.fuse.enable": "on"},
                                        stats=stats)
    assert stats["fusion"]["segments"] == SEGMENTS[name], (name, stats["fusion"])
    assert stats["fusion"]["eager"] == EAGER.get(name, {}), (name, stats["fusion"])
    assert stats["task_bytes"] > 0 and stats["plan_s"] > 0, name
