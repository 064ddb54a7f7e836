#!/usr/bin/env python3
"""The host's costs inside a stream gate step on the card, call by call.

    python3 tools/step_costs.py [--root CHECKOUT] [--tag T]

Over ``streamgate._corpus`` and the gate's view, at poll 512:

- ``read``: ``pyarrow.json.read_json`` of one poll as
  ``JsonRowDeserializer`` calls it, and with other block sizes, threads
  and sources; the deserializer whole; the record loop's ``json.loads``
  (best of a few passes over the corpus, µs a poll);
- ``ops``: one clone, one copy, a multiply-add, a cat of nine planes and
  nine views of one buffer, an event made and recorded (µs a call, CUDA
  tensors of a step's size);
- ``replay``: a pipeline of each fuse setting stepped a few times, then
  its Calc chain run on one uploaded batch (alone, and with the host read
  of its output); for the fused one its captured graph replayed alone,
  ``_Graph.replay`` whole, its input copies and its output clones (µs a
  call);
- ``graph_size``: graphs of 2, 12, 36 and 72 elementwise kernels
  replayed (µs a replay).

``--root`` imports the ``auron_tpu_torch`` of another checkout (a parent
commit unpacked beside this one), so two trees can be measured in turns
within one call; ``read`` and ``ops`` are the host's and the card's, not
the tree's. Prints one JSON line (also written to
``chiprun_out/step_costs[-<tag>].json``). Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time


def _best_per_poll(res: dict, name: str, bufs: list, f, reps: int = 5) -> None:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for b in bufs:
            f(b)
        best = min(best, (time.perf_counter() - t0) / len(bufs) * 1e6)
    res[name] = round(best, 1)


def _per_call(res: dict, name: str, f, n: int = 2000) -> None:
    import torch

    for _ in range(50):
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        f()
    torch.cuda.synchronize()
    res[name] = round((time.perf_counter() - t0) / n * 1e6, 2)


def read_costs(polls: list) -> dict:
    import json as js

    from auron_tpu_torch.exec.streaming import JsonRowDeserializer
    from auron_tpu_torch.models import streamgate as sg
    from auron_tpu_torch.utils.arrowlib import pyarrow

    pa = pyarrow()
    import pyarrow.json as pj

    res = {"pyarrow": pa.__version__}
    bufs = [b"\n".join(p) for p in polls]
    de = JsonRowDeserializer(sg.SCHEMA)
    de.deserialize(polls[0])
    schema, ro, po = de._reader

    def read(o, src=pa.BufferReader):
        return lambda b: pj.read_json(src(b), read_options=o, parse_options=po)

    _best_per_poll(res, "read_json", bufs, read(ro))
    for bs in (1 << 15, 1 << 16, 1 << 20):
        _best_per_poll(res, f"read_json_block_{bs}", bufs,
                       read(pj.ReadOptions(use_threads=False, block_size=bs)))
    _best_per_poll(res, "read_json_threads", bufs, read(pj.ReadOptions(use_threads=True)))
    _best_per_poll(res, "read_json_bytesio", bufs, read(ro, io.BytesIO))
    _best_per_poll(res, "read_json_py_buffer", bufs, read(ro, pa.py_buffer))
    it = iter(polls * 10)
    _best_per_poll(res, "deserialize", bufs, lambda b: de.deserialize(next(it)))
    _best_per_poll(res, "record_loop_json_loads", bufs,
                   lambda b: [js.loads(x) for x in b.split(b"\n")], reps=2)
    return res


def op_costs() -> dict:
    import torch

    res = {}
    x = torch.randn(512, dtype=torch.float64, device="cuda")
    m = torch.ones(512, dtype=torch.bool, device="cuda")
    s = torch.empty_like(x)
    outs = [x, x, x, x, m, m, m, m, m]
    buf = torch.cat([o.view(torch.uint8) for o in outs])
    sizes = [o.numel() * o.element_size() for o in outs]
    _per_call(res, "clone", lambda: x.clone())
    _per_call(res, "copy_", lambda: s.copy_(x))
    _per_call(res, "mul_add", lambda: x * 2.0 + 1.0)
    _per_call(res, "cat_9", lambda: torch.cat([o.view(torch.uint8) for o in outs]))
    _per_call(res, "split_view_9", lambda: [p.view(o.dtype) for p, o in zip(buf.split(sizes),
                                                                            outs)])
    _per_call(res, "event_record", lambda: torch.cuda.Event().record())
    return res


def replay_costs(parts: list) -> dict:
    from auron_tpu_torch.exec.streaming import JsonRowDeserializer, MockKafkaSource, upload_batch
    from auron_tpu_torch.models import streamgate as sg
    from auron_tpu_torch.plan import fusion
    from auron_tpu_torch.stream import CollectSink, StreamPipeline, lower_streaming_view

    res = {}
    plan = lower_streaming_view(sg.VIEW, sg.SCHEMA)
    for fuse in (True, False):
        leg = "fused" if fuse else "eager"
        p = StreamPipeline(plan, MockKafkaSource(parts), JsonRowDeserializer(sg.SCHEMA),
                           CollectSink(), conf=sg._conf(fuse, 512), device="cuda")
        for _ in range(5):
            p.step()
        b = upload_batch(p.calc.deserializer.deserialize(p.source.poll(512)), "cuda", p.conf)

        def chain(read=False):
            p._chain_src.slot = b
            for out in p._chain.execute(0, p.ctx):
                if read:
                    out.live_host_planes()

        _per_call(res, f"{leg}_chain", chain)
        _per_call(res, f"{leg}_chain_and_read", lambda: chain(True))
        if fuse:
            bi = fusion._batch_in(b.device, p._chain.reads)
            g = list(fusion._GRAPHS._graphs.values())[-1]
            res["graph_label"] = g.label
            _per_call(res, "graph.replay", lambda: g.graph.replay())
            _per_call(res, "_Graph.replay", lambda: g.replay(bi, ()))
            _per_call(res, "copies_in", lambda: [s.copy_(t) for s, t in zip(g.static_in, bi)])
            if getattr(g, "out_plan", None) is not None:
                _per_call(res, "clone_unpack",
                          lambda: fusion._unpack(g.static_out[0].clone(), g.out_plan))
            else:
                _per_call(res, "clones", lambda: [o.clone() for o in g.static_out])
        p.close()
    return res


def graph_size_costs() -> dict:
    import torch

    res = {}
    x = torch.randn(512, dtype=torch.float64, device="cuda")
    for k in (2, 12, 36, 72):
        g = torch.cuda.CUDAGraph()
        s = x.clone()
        torch.cuda.synchronize()
        with torch.cuda.graph(g):
            y = s
            for _ in range(k):
                y = y * 1.0001
        _per_call(res, f"replay_{k}_kernels", lambda: g.replay())
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="checkout whose auron_tpu_torch to import")
    ap.add_argument("--tag", default="", help="suffix of the JSON file's name")
    args = ap.parse_args(argv)
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    sys.path.insert(0, os.path.abspath(args.root or here))
    import torch

    if not torch.cuda.is_available():
        print("step_costs: no CUDA device", file=sys.stderr)
        return 2
    from auron_tpu_torch.models import streamgate as sg

    parts = sg._corpus(60000)
    polls = [parts[0][i:i + 512] for i in range(0, len(parts[0]), 512)]
    out = {"root": args.root or ".", "card": torch.cuda.get_device_name(0),
           "read": read_costs(polls), "ops": op_costs(),
           "replay": replay_costs(sg._corpus(20000)), "graph_size": graph_size_costs()}
    line = json.dumps(out)
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out",
                           f"step_costs{'-' + args.tag if args.tag else ''}.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
