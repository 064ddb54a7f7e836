"""Planned ``kafka_scan`` tasks with a keyed exchange.

A topic of JSON order events ``{"user", "item", "price", "qty", "ts"}`` in
two partitions is totalled per user in two stages, every task started
from its ``TaskDefinition`` bytes through the normal task runtime and the
file shuffle (``models/tpcds.run_task_bytes``):

- one map task per topic partition: ``kafka_scan`` (JSON,
  ``max_batch_records`` 8192; the task's split is its partition) ->
  ``filter(price > 0)`` -> ``project(user, price * qty AS amount)`` ->
  partial ``SUM(amount), COUNT(amount)`` by user ->
  ``ShuffleWriterExec(HashPartitioning(user), n_reduce)``: the writer's
  partition ids are K1's on the card, one launch per batch it receives
  (the partial aggregate holds its state to the end of its input, so one
  batch a map task);
- one reduce task per partition: ``ipc_reader`` -> final aggregate ->
  ``SortExec(total DESC, user ASC)``: K3, and K4 past one cluster.

Users are ``users`` ids, each at least once, the rest drawn Zipf(1.1) by
rank over a seeded permutation of the ids (a few heavy users, a long
tail). Prices are whole quarters, so every sum is exact in float64 and
the order of ties by total is fixed whatever order the engine adds in.
``oracle`` is the pandas group-by of the same records and ``mismatch``
holds a run against it.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np

from auron_tpu_torch import types as T
from auron_tpu_torch.exprs.ir import BinaryOp, Cast, col, lit
from auron_tpu_torch.ops.sortkeys import SortSpec
from auron_tpu_torch.plan import builders as B

SCHEMA = T.Schema.of(T.Field("user", T.INT64), T.Field("item", T.INT64),
                     T.Field("price", T.FLOAT64), T.Field("qty", T.INT32),
                     T.Field("ts", T.INT64))
TOPIC = "orders"
SOURCE = "orders_src"
MAX_BATCH_RECORDS = 8192


def corpus(n: int, users: int = 200_000, seed: int = 11,
           partitions: int = 2) -> list[list[bytes]]:
    """``n`` JSON events (``n >= users``) split into ``partitions`` equal
    runs of the topic, in event-time order."""
    if n < users:
        raise ValueError(f"{n} events cannot hold each of {users} users")
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, users + 1, dtype=np.float64)
    p = ranks ** -1.1
    drawn = rng.choice(users, n - users, p=p / p.sum())
    ids = rng.permutation(users)  # rank -> user id
    user = ids[rng.permutation(np.concatenate([np.arange(users), drawn]))]
    item = rng.integers(0, 10_000, n)
    price = rng.integers(-8, 400, n) / 4.0  # ~2 % at or below 0
    qty = rng.integers(1, 10, n)
    ts = np.arange(n, dtype=np.int64) * 7 + rng.integers(0, 7, n)
    recs = [f'{{"user":{u},"item":{i},"price":{pr!r},"qty":{q},"ts":{t}}}'.encode()
            for u, i, pr, q, t in zip(user.tolist(), item.tolist(), price.tolist(),
                                      qty.tolist(), ts.tolist())]
    per = (n + partitions - 1) // partitions
    return [recs[k * per:(k + 1) * per] for k in range(partitions)]


def _partial(scan):
    """scan -> filter(price > 0) -> project(user, price * qty) -> partial
    sum and count by user."""
    f = B.filter_(scan, [BinaryOp("gt", col(2), lit(0.0))])
    proj = B.project(f, [(col(0), "user"),
                         (BinaryOp("mul", col(2), Cast(col(3), T.FLOAT64)), "amount")])
    return B.hash_agg(proj, [(col(0), "user")],
                      [("sum", col(1), "total"), ("count", col(1), "n")], "partial")


def map_plan(data_file: str, index_file: str, n_reduce: int,
             max_batch_records: int = MAX_BATCH_RECORDS):
    """One map task's plan: the partial aggregate of its split, hash-
    shuffled on user into ``n_reduce`` partitions."""
    scan = B.kafka_scan(SCHEMA, TOPIC, SOURCE, data_format="json",
                        max_batch_records=max_batch_records)
    return B.shuffle_writer(_partial(scan), B.hash_partitioning([col(0)], n_reduce),
                            data_file, index_file)


def inter_schema() -> T.Schema:
    """The partial aggregate's output: what the shuffle carries."""
    from auron_tpu_torch.plan.planner import tree_from_plan

    return tree_from_plan(_partial(B.kafka_scan(SCHEMA, TOPIC, SOURCE))).schema


def reduce_plan(reader_rid: str):
    """The final aggregate of one partition, ordered by total DESC, user ASC."""
    read = B.ipc_reader(inter_schema(), reader_rid)
    agg = B.hash_agg(read, [(col(0), "user")],
                     [("sum", col(1), "total"), ("count", col(2), "n")], "final")
    return B.sort(agg, [(col(1), SortSpec(asc=False)), (col(0), SortSpec())])


def split_source(parts: list[list[bytes]], pid: int):
    """The ``kafka_scan`` resource of the map task reading topic partition
    ``pid``: a source factory in the ``(topic, startup_mode, offsets)``
    convention over that partition alone."""
    from auron_tpu_torch.exec.streaming import MockKafkaSource

    return lambda topic, mode, offsets: MockKafkaSource(
        parts, startup_mode=mode, start_offsets=offsets, partitions=[pid])


def run(parts: list[list[bytes]], n_reduce: int = 4, device="cuda",
        work_dir: str | None = None, conf: dict | None = None,
        stats: dict | None = None) -> list[dict]:
    """Both stages; returns each reduce partition's ``{user, total, n}`` in
    its output order. ``stats`` gets ``map_s``, ``reduce_s``, ``wall_s``,
    ``stream_batches``, ``deserialize_s``, ``shuffle_bytes``, the map
    tasks' ``offsets`` (``kafka_offset_p*``) and ``rows`` per partition."""
    from auron_tpu_torch.exec.metrics import MetricNode
    from auron_tpu_torch.exec.shuffle.reader import MultiMapBlockProvider
    from auron_tpu_torch.models.tpcds import collect, run_task_bytes

    stats = stats if stats is not None else {}
    work = work_dir or tempfile.mkdtemp(prefix="auron_kafka_exchange_")
    os.makedirs(work, exist_ok=True)
    rid = "orders_ex0"
    try:
        t0 = time.perf_counter()
        pairs, offsets = [], {}
        totals = {"stream_batches": 0, "deserialize_time": 0, "data_size": 0}
        for p in range(len(parts)):
            d, i = (os.path.join(work, f"{rid}_m{p}.{ext}") for ext in ("data", "index"))
            pairs.append((d, i))
            task = B.task(map_plan(d, i, n_reduce), 1, p, conf)
            _, m = run_task_bytes(task.SerializeToString(), {SOURCE: split_source(parts, p)},
                                  device)
            flat = MetricNode.flat_totals(m)
            for k in totals:
                totals[k] += flat.get(k, 0)
            offsets.update({int(k[len("kafka_offset_p"):]): v for k, v in flat.items()
                            if k.startswith("kafka_offset_p")})
        t1 = time.perf_counter()
        outs = []
        for r in range(n_reduce):
            task = B.task(reduce_plan(rid), 2, r, conf)
            batches, _ = run_task_bytes(task.SerializeToString(),
                                        {rid: MultiMapBlockProvider(pairs)}, device)
            got = collect(batches)
            outs.append({k: got.get(k, np.empty(0)) for k in ("user", "total", "n")})
        t2 = time.perf_counter()
        stats.update(map_s=t1 - t0, reduce_s=t2 - t1, wall_s=t2 - t0,
                     stream_batches=totals["stream_batches"],
                     deserialize_s=totals["deserialize_time"] / 1e9,
                     shuffle_bytes=totals["data_size"], offsets=offsets,
                     rows=[len(o["user"]) for o in outs])
        return outs
    finally:
        if work_dir is None:
            shutil.rmtree(work, ignore_errors=True)


def oracle(parts: list[list[bytes]]):
    """The pandas group-by of the records: ``user``, ``total`` (sum of
    price * qty over price > 0), ``n`` (their count), by user."""
    import json

    import pandas as pd

    df = pd.DataFrame([json.loads(r) for part in parts for r in part])
    df = df[df["price"] > 0]
    df = df.assign(amount=df["price"] * df["qty"].astype(np.float64))
    g = df.groupby("user")["amount"].agg(["sum", "count"]).reset_index()
    return g.rename(columns={"sum": "total", "count": "n"})


def micro_batches(parts: list[list[bytes]], max_batch_records: int = MAX_BATCH_RECORDS) -> int:
    """The micro-batches the map tasks poll: each partition's records in
    polls of ``max_batch_records``."""
    return sum(-(-len(p) // max_batch_records) for p in parts)


def mismatch(outs: list[dict], want, rel: float = 1e-9) -> str | None:
    """None when the reduce outputs are the oracle's rows, each user in the
    partition Spark's murmur3 pmod gives it (the plain version of K1), each
    partition in (total DESC, user ASC) order, counts exact and totals at
    ``rel``; else what differs."""
    import torch

    from auron_tpu_torch.ops.partition_kernels import plain_partition_ids

    users = np.array(want["user"], dtype=np.int64)
    pid = plain_partition_ids(torch.from_numpy(users), torch.ones(len(users), dtype=torch.bool),
                              len(outs)).numpy()
    for r, o in enumerate(outs):
        w = want[pid == r]
        order = np.lexsort((w["user"].to_numpy(), -w["total"].to_numpy()))
        wu = w["user"].to_numpy(np.int64)[order]
        if len(o["user"]) != len(wu) or not np.array_equal(np.asarray(o["user"], np.int64), wu):
            return f"partition {r}: users or their order differ ({len(o['user'])} vs {len(wu)})"
        if not np.array_equal(np.asarray(o["n"], np.int64), w["n"].to_numpy(np.int64)[order]):
            return f"partition {r}: counts differ"
        wt = w["total"].to_numpy(np.float64)[order]
        if not np.allclose(np.asarray(o["total"], np.float64), wt, rtol=rel, atol=0.0):
            return f"partition {r}: totals differ past rel {rel}"
    return None
