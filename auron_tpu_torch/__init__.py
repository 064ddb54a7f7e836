"""auron_tpu_torch: the query engine on PyTorch and CUDA (NVIDIA Hopper).

The same plan protos, operators and Spark-exact semantics as the JAX
package ``auron_tpu``, executed as eager PyTorch programs on a CUDA device,
with the sort network hand-written in CUDA C++ for ``sm_90a``
(``csrc/bitonic.cu``).

Layout mirrors ``auron_tpu``: ``types`` -> ``columnar/`` -> ``exprs/`` ->
``ops/`` (word helpers, hashing, sort keys, the bitonic kernels,
segmentation) -> ``exec/`` (scan, project, filter, limit, broadcast hash
join, hash aggregate, sort) -> ``proto/`` + ``plan/`` + ``runtime/`` +
``bridge/`` (with the C ABI in ``csrc/``) -> ``convert/`` -> ``models/``
(TPC-DS-class data and pipelines).

Rules of the package:

- it imports ``torch`` and ``numpy``; never ``jax``, nothing of
  ``auron_tpu`` (what it needs from there is copied, with a pointer) and
  never ``google.protobuf`` (plan messages come from its own proto3 codec,
  ``proto/``);
- ``pyarrow`` and ``pandas`` are imported only inside the functions that
  need them (Arrow/pandas interop);
- every entry point takes an explicit ``device`` defaulting to ``"cuda"``;
  asking for CUDA without a card raises — nothing falls back to the CPU.
"""

__version__ = "0.1.0"
