"""The port's C ABI (``auron_tpu_torch/csrc/``), built here with g++/cc by
``ops/cuda_build.build_bridge``, driven by its stand-in C host:

- q42 at SF 0.02 through ``bridge_harness`` with the CPU asked for
  (``AURON_TORCH_DEVICE=cpu``): its IPC output equals the port's own run
  exactly, the numpy oracle (brands exact, revenue at rel 1e-9) and the
  reference harness's output on the same TaskDefinition (the JAX
  package's ``native/`` bridge, built into a temporary directory: brands
  exact, revenue at rel 1e-9, the summation orders differ);
- without the CPU request the harness fails with the port's no-card error;
- q93 with its reduce tasks reading ``shuffle:<id>`` manifests, through
  harness processes and through the library loaded in-process, equal to its
  oracle;
- ``bridge_harness --convert`` with the CPU asked for returns the port's
  in-process segmentation response for q93's host plan (the stage
  namespace replaced), and for ``{}`` the reference's error response with
  rc 0;
- ``auron_register_udf_callback`` installs a host evaluator (answers 0)
  and removes it again given NULL.
"""

import ctypes
import json
import os
import subprocess
import sys
import sysconfig

import numpy as np
import pytest
import torch

from auron_tpu_torch.bridge import host as phost
from auron_tpu_torch.columnar import arrow_ipc
from auron_tpu_torch.models import tpcds as pt
from auron_tpu_torch.ops import cuda_build
from auron_tpu_torch.plan import builders as PB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data():
    return pt.generate(0.02, 42)


def _q42_job(d):
    host = pt.host_q42(d)
    task = PB.task(pt.q42_plan(pt._ffi_reader)).SerializeToString()
    return task, {"q42_fact": arrow_ipc.write_stream(host["q42_fact"], pt.STORE_SALES_SCHEMA),
                  "q42_item": arrow_ipc.write_stream(host["q42_item"], pt.ITEM_SCHEMA)}


def _rows(batches) -> tuple[list, list]:
    brand, rev = [], []
    for hb in batches:
        dct = hb.to_pydict()
        brand += dct["brand"]
        rev += dct["rev"]
    return brand, rev


def _reference_harness(tmp_path) -> str:
    """``native/bridge_harness`` and its library built into ``tmp_path`` with
    the Makefile's commands (no build inside the source tree)."""
    native = os.path.join(REPO, "native")
    inc = subprocess.run(["python3-config", "--includes"], capture_output=True, text=True,
                         check=True).stdout.split()
    ld = subprocess.run(["python3-config", "--ldflags", "--embed"], capture_output=True,
                        text=True, check=True).stdout.split()
    libdir = sysconfig.get_config_var("LIBDIR")
    so, exe = str(tmp_path / "libauron_bridge.so"), str(tmp_path / "bridge_harness")
    for cmd in (["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-o", so,
                 os.path.join(native, "auron_bridge.cpp"), *inc, *ld, f"-Wl,-rpath,{libdir}"],
                ["cc", "-O2", "-Wall", f"-I{native}", "-o", exe,
                 os.path.join(native, "bridge_harness.c"), f"-L{tmp_path}",
                 "-Wl,-rpath,$ORIGIN", "-lauron_bridge"]):
        r = subprocess.run(cmd, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-2000:]
    return exe


def test_build_is_cached_by_source_hash():
    so, harness = cuda_build.build_bridge()
    assert os.path.exists(so) and os.access(harness, os.X_OK)
    assert cuda_build.build_bridge() == (so, harness) == cuda_build.bridge_paths()
    assert os.path.basename(so).startswith("libauron_bridge-")


def test_q42_through_the_harness_on_the_cpu(data, tmp_path):
    task, resources = _q42_job(data)
    (run,) = phost.run_harnesses([(task, resources)], str(tmp_path / "port"), "cpu", "q42")
    brand, rev = _rows(run.batches)
    mine = pt.run_q42_class(data, device="cpu")
    assert brand == mine["brand"].tolist() and rev == mine["rev"].tolist()
    want = pt.q42_class_oracle(data)
    assert brand == want["brand"].tolist()
    np.testing.assert_allclose(rev, want["rev"], rtol=1e-9, atol=0)
    assert run.metrics["task"]["task_bytes"] == len(task)
    assert run.metrics["kernel_launches"]["bitonic_sort"] == 0  # the CPU runs no kernel
    assert 0 < run.init_s < run.process_s and 0 < run.task_s < run.process_s
    # the reference's bridge and harness on the same bytes and resources
    # (pyarrow decodes the port's IPC streams there)
    exe = _reference_harness(tmp_path)
    paths = []
    for i, (k, v) in enumerate(resources.items()):
        (tmp_path / f"r{i}").write_bytes(v)
        paths += [k, str(tmp_path / f"r{i}")]
    (tmp_path / "task.bin").write_bytes(task)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p),
               JAX_PLATFORMS="cpu", AURON_TPU_ROOT=REPO)
    r = subprocess.run([exe, str(tmp_path / "task.bin"), str(tmp_path / "ref.out"), *paths],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    rbrand, rrev = _rows(phost.read_framed((tmp_path / "ref.out").read_bytes()))
    assert rbrand == brand
    np.testing.assert_allclose(rrev, rev, rtol=1e-9, atol=0)


def test_the_harness_without_the_cpu_request_needs_a_card(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    task, resources = _q42_job(data)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available.. is False"):
        phost.run_harnesses([(task, resources)], str(tmp_path), "cuda", "q42")


def _harness_convert(tmp_path, payload: bytes):
    _, harness = cuda_build.build_bridge()
    (tmp_path / "plan.json").write_bytes(payload)
    r = subprocess.run([harness, "--convert", str(tmp_path / "plan.json"),
                        str(tmp_path / "resp.json")], env=phost.harness_env("cpu"),
                       capture_output=True, text=True, timeout=300)
    return r, (tmp_path / "resp.json").read_bytes() if r.returncode == 0 else None


def test_convert_plan_relays_not_implemented(tmp_path):
    """The conversion entry relays a failed conversion as the reference's
    service does: ``{}`` comes back as an error response, rc 0, where it
    raised NotImplementedError before the converters were ported."""
    r, resp = _harness_convert(tmp_path, b"{}")
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(resp) == {"converted": False, "error": "KeyError: 'op'"}
    from auron_tpu.convert.service import convert_host_plan_json

    assert resp == convert_host_plan_json(b"{}")


def test_convert_plan_through_the_harness_equals_the_in_process_response(tmp_path):
    """q93's host plan through ``bridge_harness --convert`` (the CPU asked
    for) gives the port's in-process response, once the stage namespace
    (pid and conversion counter) is replaced."""
    from auron_tpu_torch.bridge import api

    plan = json.dumps(pt.q93_host_plan(4)).encode()
    r, resp = _harness_convert(tmp_path, plan)
    assert r.returncode == 0, r.stderr[-2000:]
    mine = api.convert_plan_json(plan)
    assert json.loads(resp)["converted"] is True
    assert pt.namespace_free(resp) == pt.namespace_free(mine)
    assert pt.namespace_free(resp) != json.loads(resp)  # the namespace was there
    assert len(json.loads(resp)["root"]["stages"]) == 2


def test_q93_stages_of_the_harness_response_through_the_library(data, tmp_path,
                                                                monkeypatch):
    """The harness's response, its stages run through ``libauron_bridge``
    loaded in this process (tasks, manifests and answers across the C ABI),
    equals the oracle."""
    monkeypatch.setenv("AURON_TORCH_DEVICE", "cpu")
    r, resp = _harness_convert(tmp_path, json.dumps(pt.q93_host_plan(2)).encode())
    assert r.returncode == 0, r.stderr[-2000:]
    st: dict = {}
    got = pt.run_q93_converted(data, n_map=3, n_reduce=2, device="cpu",
                               response=json.loads(resp), via="library", stats=st)
    want = pt.q93_class_oracle(data)
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["matched"], want["matched"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9, atol=0)
    assert st["stages"] == 2 and len(st["tasks"]) == 5 and "convert_s" not in st


def test_q93_shuffle_manifests_through_harness_processes(data, tmp_path):
    stats: dict = {}
    got = pt.run_q93_c_abi(data, n_map=2, n_reduce=2, device="cpu", via="process",
                           work_dir=str(tmp_path), stats=stats)
    want = pt.q93_class_oracle(data)
    assert got["k_null"].tolist() == want["k_null"].tolist()
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["matched"], want["matched"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9, atol=0)
    assert len(stats["processes"]) == 4 and stats["resource_bytes"] > 0
    assert stats["shuffle_bytes"] > 0 and stats["task_bytes"] > 0


def test_q93_through_the_library_in_process(data, tmp_path, monkeypatch):
    """The library loaded into this process with ctypes: q93 with a shuffle
    manifest, then the UDF entry installing and removing an evaluator."""
    monkeypatch.setenv("AURON_TORCH_DEVICE", "cpu")
    got = pt.run_q93_c_abi(data, n_map=3, n_reduce=2, device="cpu", via="library",
                           work_dir=str(tmp_path))
    want = pt.q93_class_oracle(data)
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["matched"], want["matched"])
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9, atol=0)
    from auron_tpu_torch.bridge import udf

    lib = phost.CLibrary("cpu")._lib
    lib.auron_register_udf_callback.argtypes = [ctypes.c_void_p]
    evaluator = ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)
    assert lib.auron_register_udf_callback(ctypes.cast(evaluator, ctypes.c_void_p).value) == 0
    assert udf.host_callback_installed()
    assert lib.auron_register_udf_callback(None) == 0
    assert not udf.host_callback_installed()
    with pytest.raises(RuntimeError, match="shuffle files"):
        phost.CLibrary("cpu").put_resource_shuffle("x", b'[{"data": "/nope", "index": "/no"}]')
