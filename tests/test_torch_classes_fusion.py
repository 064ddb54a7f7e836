"""Whole classes at SF 0.02 with this slice's keys on and off (whole-stage
fusion, the standalone fused filter, the incremental probe and merge-path,
with the fingerprint sort they need), each equal to its numpy oracle: q42,
q3, q93, q33, q5, the decimal q42, and the probe class (a generic aggregate
keyed by (item, date) whose keys repeat across batches). Keys and counts
exact, float sums at rel 1e-9, the decimal q42 exactly."""

import numpy as np
import pytest

from auron_tpu_torch.models import tpcds
from auron_tpu_torch.plan import fusion
from torch_classes import assert_same

SF = 0.02
SLICE_KEYS = ("exec.fuse.enable", "exec.fuse.probe", "exec.fuse.shuffle",
              "exec.agg.incremental.probe", "exec.agg.incremental.mergepath",
              "exec.agg.incremental.fingerprint")


def _conf(mode: str) -> dict:
    conf = {k: mode for k in SLICE_KEYS}
    conf["exec.filter.fuse"] = "true" if mode == "on" else "false"
    conf["exec.fuse.agg.inputs"] = conf["exec.filter.fuse"]
    return conf


@pytest.fixture(scope="module")
def data():
    return tpcds.generate(SF, 42)


def _run(name: str, data, mode: str, stats: dict) -> dict:
    run = getattr(tpcds, f"run_{name}_class")
    conf = _conf(mode)
    if name in ("q3", "q93", "q5"):
        return run(data, n_map=2, n_reduce=2, device="cpu", conf=conf, stats=stats)
    return run(data, device="cpu", conf=conf, stats=stats)


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("name", ["q42", "q3", "q93", "q33", "q5", "q42_decimal"])
def test_class_equals_oracle(data, name, mode):
    stats: dict = {}
    fusion.reset_fusion_stats()
    got = _run(name, data, mode, stats)
    want = getattr(tpcds, f"{name}_class_oracle")(data)
    if name == "q42_decimal":
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.asarray(got[k]).tolist() == np.asarray(want[k]).tolist(), k
    else:
        rev = {"q42": ("rev",), "q3": ("s",), "q93": ("s",)}.get(name, ())
        for k in want:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            if k in rev or g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=f"{name} {k}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{name} {k}")
    fused = stats["fusion"]
    if mode == "on":
        assert fused["segments"] > 0 and fused["fused_batches"] > 0, fused
    else:
        assert fused["segments"] == 0 and fused["fused_batches"] == 0, fused


@pytest.mark.parametrize("mode", ["on", "off"])
def test_probe_class_equals_oracle(data, mode):
    """The probe class over 4,096-row batches: with the keys on, the final
    aggregate's state is probed by every later batch; the answer (sum,
    count, min, max and first) equals the oracle either way."""
    ingested = {"probe_fact": tpcds.to_batches(data.store_sales, 1, 4096, "cpu")}
    stats: dict = {}
    got = tpcds.run_probe_agg_class(data, device="cpu", conf={**_conf(mode), "batch.size": 2048},
                                    ingested=ingested, stats=stats)
    want = tpcds.probe_agg_class_oracle(data)
    assert_same({k: got[k] for k in want}, want, f"probe ({mode})")
    counters = stats["counters"]
    if mode == "on":
        assert counters.get("HashAggExec.probe_batches", 0) > 0, counters
        assert counters.get("HashAggExec.merge_path_merges", 0) > 0, counters
    else:
        assert "HashAggExec.probe_batches" not in counters
