"""Bitonic cluster sort: the engine's sort primitive, CUDA kernels + plain torch.

Port of ``auron_tpu/ops/bitonic.py``. The operands of a stable multi-key
sort (key words + a distinct int32 payload as the last operand) split into
uint32 planes, most significant first; the payload is the last compare
plane, so the order is total and the bitonic network's result equals the
stable sort it replaces (``lax.sort(ops, num_keys=n-1)`` in the JAX
package, a stable multi-pass ``torch.sort`` here).

Two implementations of the same network:

- the CUDA kernels in ``csrc/bitonic.cu`` (route: nvcc + ctypes), issued
  by ``kernel_sort_`` / ``kernel_merge_`` as the launches that
  ``sort_plan(NP, P)`` lists, in one ctypes call: a sort that fits one
  thread-block cluster (up to 16 x 2048 elements at 2..16 planes) is one
  ``bitonic_cluster`` launch (K3, replacing the Pallas ``_bitonic_kernel``);
  a larger one adds, per merge stage, ``bitonic_strides`` launches of up to
  three strides and a ``bitonic_cluster`` tail (K4, replacing the Pallas
  ``_merge_kernel``). Other plane counts take the general shared-memory
  kernels (``bitonic_local`` / ``bitonic_global``);
- the plain torch network (``_network`` / ``_merge_network``): two rolls +
  a select per substage, as in the JAX package. The CPU tests run it, and
  ``chip_smoke.py`` holds the kernels against it on the card.

``impl`` keeps the JAX package's values so a host conf means the same
thing: ``"pallas"`` selects the CUDA kernels (the plain network for CPU
tensors — on a CUDA tensor the kernel launches or the call raises, there is
no fallback), ``"jnp"`` the plain network.

Carrier convention (see ops/uwords.py): torch has no unsigned shifts or
compares on the CPU, so the JAX package's uint64 words travel as int64 bit
patterns and uint32 planes as int64 values in [0, 2^32) — signed compares
of those equal the unsigned compares the network needs. The kernels read
the planes as ``unsigned`` from int32 tensors with the same bits: on a
CUDA tensor the operands split straight into int32 planes
(``_split_planes32``) and join back from them, so the int64 carrier is
only the plain network's.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import torch

from auron_tpu_torch.ops import launch_count
from auron_tpu_torch.ops.uwords import MASK32, flip, hi32, i32_of_u32, join32, lo32, u32_of_i32
from auron_tpu_torch.utils.config import DEVICE_SORT_IMPL, active_conf

_LANES = 128
_MIN_P = 2048  # auto: below this the network is not worth its setup
_MAX_P = 1 << 30  # the kernels index a plane with 32 bits
# register kernels (csrc/bitonic.cu bitonic_cluster / bitonic_strides)
_MAX_NP = 16  # the largest plane count they are compiled for
_TILE = 2048  # elements a CTA of bitonic_cluster holds at most ...
_MIN_TILE = 512  # ... and at least, where P allows ...
_PER_THREAD = 4  # ... 4 of them a thread (csrc/bitonic.cu kPerThread)
_MAX_CLUSTER = 16  # CTAs a cluster (Hopper's non-portable limit)
_MAX_STRIDES = 3  # strides a bitonic_strides launch runs (8 elements a thread) ...
_MAX_STRIDES_NP = 10  # ... up to this plane count, two above it (register spills)
# general kernels (bitonic_local / bitonic_global), for any plane count
_SMEM_TILE_BYTES = 96 * 1024  # shared memory per CTA the tile may use
_MAX_TILE = 2048  # 1024 threads x one pair each per substage

#: kernel launches, by the kernel they stand for: K3 (the sort launch of a
#: plan) and K4 (its merge launches)
LAUNCHES = {"bitonic_sort": 0, "bitonic_merge": 0}
_launch_lock = threading.Lock()  # task pumps run on their own threads


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _default_kind(t: torch.Tensor) -> str:
    # the port carries uint64 words as int64, so an int64 operand is a
    # word unless the caller says "i64"
    if t.dtype == torch.int64:
        return "u64"
    if t.dtype == torch.int32:
        return "i32"
    raise TypeError(f"bitonic operand dtype {t.dtype}")


def _split_planes(operands, narrow, kinds) -> list[torch.Tensor]:
    """Operands -> uint32 planes as int64 carriers, most significant first.
    u64: hi/lo words (narrow: lo only — the caller guarantees hi == 0);
    i64: sign-biased hi + lo; i32: sign-biased single plane; u32: as is."""
    planes: list[torch.Tensor] = []
    for op, nw, kind in zip(operands, narrow, kinds):
        if kind == "u64":
            if not nw:
                planes.append(hi32(op))
            planes.append(lo32(op))
        elif kind == "i64":
            planes.append(hi32(op) ^ 0x80000000)
            planes.append(lo32(op))
        elif kind == "i32":
            planes.append(u32_of_i32(op) ^ 0x80000000)
        elif kind == "u32":  # int64 carrier, or the int32 with the same bits
            planes.append(op.to(torch.int64) & MASK32)
        else:
            raise TypeError(f"bitonic operand kind {kind}")
    return planes


def _join_planes(flat: torch.Tensor, operands, narrow, kinds) -> tuple:
    """Inverse of _split_planes over sorted planes (NP, cap)."""
    out = []
    i = 0
    for op, nw, kind in zip(operands, narrow, kinds):
        if kind == "u64":
            if nw:
                out.append(flat[i].clone())
                i += 1
            else:
                out.append(join32(flat[i], flat[i + 1]))
                i += 2
        elif kind == "i64":
            out.append(join32(flat[i] ^ 0x80000000, flat[i + 1]))
            i += 2
        elif kind == "i32":
            out.append(i32_of_u32(flat[i] ^ 0x80000000))
            i += 1
        else:  # u32: back in the operand's own carrier
            out.append(i32_of_u32(flat[i]) if op.dtype == torch.int32 else flat[i].clone())
            i += 1
    return tuple(out)


_SIGN32 = -(1 << 31)  # int32 bit pattern of 0x80000000


def _low_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 as the int32 with the same bits (the shift
    pair sign-extends them, so the narrowing stays in range)."""
    return ((x << 32) >> 32).to(torch.int32)


def _split_planes32(operands, narrow, kinds) -> list[torch.Tensor]:
    """_split_planes with int32 storage carriers: the planes the kernels
    read, built without the int64 round trip."""
    planes: list[torch.Tensor] = []
    for op, nw, kind in zip(operands, narrow, kinds):
        if kind in ("u64", "i64"):
            if kind == "i64" or not nw:
                hi = (op >> 32).to(torch.int32)
                planes.append(hi ^ _SIGN32 if kind == "i64" else hi)
            planes.append(_low_i32(op))
        elif kind == "i32":
            planes.append(op ^ _SIGN32)
        elif kind == "u32":
            planes.append(op if op.dtype == torch.int32 else _low_i32(op))
        else:
            raise TypeError(f"bitonic operand kind {kind}")
    return planes


def _join_planes32(flat: torch.Tensor, operands, narrow, kinds) -> tuple:
    """Inverse of _split_planes32 over sorted int32 planes (NP, cap)."""
    out = []
    i = 0
    for op, nw, kind in zip(operands, narrow, kinds):
        if kind in ("u64", "i64"):
            if kind == "u64" and nw:
                out.append(u32_of_i32(flat[i]))
                i += 1
                continue
            hi = flat[i] ^ _SIGN32 if kind == "i64" else flat[i]
            out.append((hi.to(torch.int64) << 32) | u32_of_i32(flat[i + 1]))
            i += 2
        elif kind == "i32":
            out.append(flat[i] ^ _SIGN32)
            i += 1
        else:
            out.append(flat[i].clone() if op.dtype == torch.int32 else u32_of_i32(flat[i]))
            i += 1
    return tuple(out)


# ---------------------------------------------------------------------------
# plain torch network (the kernels' reference; runs for CPU tensors)
# ---------------------------------------------------------------------------


def _substage(x: torch.Tensor, flat: torch.Tensor, k: int, j: int) -> torch.Tensor:
    """One compare-exchange substage over planes x (NP, P) of int64 uint32
    carriers: partner by two rolls + select, lexicographic compare across
    planes, want_max = bit_j != bit_k."""
    jbit = (flat & j) != 0
    want_max = jbit != ((flat & k) != 0)
    partner = torch.where(jbit, torch.roll(x, j, dims=1), torch.roll(x, -j, dims=1))
    lt = torch.zeros_like(jbit)
    eq = torch.ones_like(jbit)
    for p in range(x.shape[0]):
        a, b = x[p], partner[p]
        lt = lt | (eq & (a < b))
        eq = eq & (a == b)
    return torch.where(lt == want_max, partner, x)


def _network(x: torch.Tensor, P: int) -> torch.Tensor:
    """The full bitonic sort network."""
    flat = torch.arange(P, device=x.device)
    k = 2
    while k <= P:
        j = k // 2
        while j >= 1:
            x = _substage(x, flat, k, j)
            j //= 2
        k *= 2
    return x


def _merge_network(x: torch.Tensor, P: int) -> torch.Tensor:
    """The final stage only (k = P): one bitonic sequence -> ascending."""
    flat = torch.arange(P, device=x.device)
    j = P // 2
    while j >= 1:
        x = _substage(x, flat, P, j)
        j //= 2
    return x


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/bitonic.cu)
# ---------------------------------------------------------------------------

#: launch kinds of a plan, as csrc/bitonic.cu's auron_bitonic_run numbers them
_KINDS = {"cluster": 0, "strides": 1, "local": 2, "global": 3}


@dataclass(frozen=True)
class Launch:
    """One kernel launch of a plan: stages k_lo..k_hi (powers of two), each
    from stride min(k/2, j_hi) down to j_lo. ``counts_as`` is the
    ``LAUNCHES`` key it adds one to."""

    kernel: str  # "cluster" | "strides" | "local" | "global"
    counts_as: str  # "bitonic_sort" | "bitonic_merge"
    k_lo: int
    k_hi: int
    j_hi: int
    j_lo: int

    def substages(self) -> list[tuple[int, int]]:
        out = []
        k = self.k_lo
        while k <= self.k_hi:
            j = min(k // 2, self.j_hi)
            while j >= self.j_lo:
                out.append((k, j))
                j //= 2
            k *= 2
        return out


@dataclass(frozen=True)
class SortPlan:
    """The launches that sort (or merge) NP planes of P elements on the
    card: ``tile`` elements a CTA, ``per_thread`` of them a thread (0 on the
    general kernels), ``cluster`` CTAs a cluster (1 on the general kernels)."""

    NP: int
    P: int
    tile: int
    per_thread: int
    cluster: int
    launches: tuple[Launch, ...]

    @property
    def registers(self) -> bool:
        """True on the register/cluster kernels, False on the general ones."""
        return self.per_thread > 0

    def substages(self) -> list[tuple[int, int]]:
        return [kj for launch in self.launches for kj in launch.substages()]

    def launch_counts(self) -> dict[str, int]:
        counts = dict.fromkeys(LAUNCHES, 0)
        for launch in self.launches:
            counts[launch.counts_as] += 1
        return counts

    def smem_bytes(self) -> int:
        """Dynamic shared memory a CTA of the plan's tile kernels takes."""
        return self.NP * self.tile * 4


def tile_for(n_planes: int, P: int) -> int:
    """Elements per CTA tile of the general kernels: the largest power of
    two <= _MAX_TILE whose planes fit the shared-memory budget, capped at P."""
    T = _MAX_TILE
    while T > 2 and n_planes * T * 4 > _SMEM_TILE_BYTES:
        T //= 2
    return min(T, P)


def _stages(lo: int, hi: int) -> list[int]:
    out = []
    k = lo
    while k <= hi:
        out.append(k)
        k *= 2
    return out


@functools.lru_cache(maxsize=None)
def sort_plan(NP: int, P: int, merge: bool = False) -> SortPlan:
    """The launches of a sort of NP planes x P elements (``merge``: of the
    final stage only, k = P, which merges one bitonic sequence).

    NP in 2.._MAX_NP and P >= 32 * _PER_THREAD take the register kernels:
    one ``bitonic_cluster`` launch sorts up to a cluster of C <= 16 CTAs x
    ``_TILE`` elements (the whole sort where P fits; the tile is P / 16,
    but at least ``_MIN_TILE``, so small sorts still spread over several
    SMs); each later stage k is ``bitonic_strides`` launches of up to
    three strides each (two above ``_MAX_STRIDES_NP`` planes) for the
    strides of one cluster's span and more, then one ``bitonic_cluster``
    launch in tail mode for the rest. Other NP take the general kernels: a
    ``bitonic_local`` tile sort, then per stage one ``bitonic_global``
    launch a stride down to the tile and a ``bitonic_local`` tail."""
    if P < 2 or P & (P - 1) or P > _MAX_P:
        raise ValueError(f"bitonic kernel needs a power-of-two length up to 2^30, got {P}")
    if NP < 1:
        raise ValueError(f"bitonic kernel needs at least one plane, got {NP}")
    stages = [P] if merge else None
    launches: list[Launch] = []
    E = _PER_THREAD
    if 2 <= NP <= _MAX_NP and P >= 32 * E:
        # spread the sort over as many CTAs as a cluster takes, down to
        # _MIN_TILE elements each
        T = min(P, _TILE, max(_MIN_TILE, P // _MAX_CLUSTER))
        C = min(P // T, _MAX_CLUSTER)
        span = C * T
        max_strides = _MAX_STRIDES if NP <= _MAX_STRIDES_NP else _MAX_STRIDES - 1
        if not merge:
            launches.append(Launch("cluster", "bitonic_sort", 2, span, span // 2, 1))
            stages = _stages(2 * span, P)
        for k in stages:
            j = k // 2
            while j >= span:
                m = min(max_strides, (j // span).bit_length())
                launches.append(Launch("strides", "bitonic_merge", k, k, j, j >> (m - 1)))
                j >>= m
            launches.append(Launch("cluster", "bitonic_merge", k, k, span // 2, 1))
        return SortPlan(NP, P, T, E, C, tuple(launches))
    T = tile_for(NP, P)
    if not merge:
        launches.append(Launch("local", "bitonic_sort", 2, T, T // 2, 1))
        stages = _stages(2 * T, P)
    for k in stages:
        j = k // 2
        while j >= T:
            launches.append(Launch("global", "bitonic_merge", k, k, j, j))
            j //= 2
        launches.append(Launch("local", "bitonic_merge", k, k, T // 2, 1))
    return SortPlan(NP, P, T, 0, 1, tuple(launches))


@functools.lru_cache(maxsize=None)
def _descriptors(plan: SortPlan):
    """The plan as auron_bitonic_run's rows of 4 int64 {kind, a, b, c}."""
    rows = []
    for launch in plan.launches:
        if launch.kernel == "cluster":
            row = (launch.k_lo, launch.k_hi, 0)
        elif launch.kernel == "strides":
            row = (launch.k_lo, launch.j_hi, (launch.j_hi // launch.j_lo).bit_length())
        elif launch.kernel == "local":
            row = (0 if launch.counts_as == "bitonic_sort" else launch.k_lo, 0, 0)
        else:
            row = (launch.k_lo, launch.j_hi, 0)
        rows.extend((_KINDS[launch.kernel], *row))
    return (ctypes.c_longlong * len(rows))(*rows)


_lib_handle = None
_prepared: dict = {}  # (device, NP, tile, cluster) -> clusters the card holds at once


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from auron_tpu_torch.ops import cuda_build

        lib = cuda_build.load("bitonic")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.auron_bitonic_prepare.argtypes = [ci, ci, ci, ci]
        lib.auron_bitonic_prepare.restype = ci
        lib.auron_bitonic_run.argtypes = [vp, ci, cll, ci, ci, ci, ctypes.POINTER(cll), ci, vp]
        lib.auron_bitonic_run.restype = ci
        lib.auron_cuda_error_string.argtypes = [ci]
        lib.auron_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check(rc: int) -> None:
    if rc != 0:
        msg = _lib().auron_cuda_error_string(rc).decode()
        raise RuntimeError(f"bitonic CUDA kernel failed: error {rc} ({msg})")


def _prepare(plan: SortPlan, device: torch.device) -> None:
    """Once per (device, NP, tile, cluster): raise the cluster kernel's
    shared-memory limit and make sure the card can schedule the cluster."""
    key = (device.index, plan.NP, plan.tile, plan.cluster)
    if not plan.registers or key in _prepared:
        return
    with _launch_lock:
        if key not in _prepared:
            n = _lib().auron_bitonic_prepare(plan.NP, plan.tile, plan.cluster, plan.per_thread)
            if n < 0:
                _check(-n)
            if n == 0:
                raise RuntimeError(
                    f"bitonic: a cluster of {plan.cluster} CTAs x {plan.smem_bytes()} B of "
                    f"shared memory (NP {plan.NP}, tile {plan.tile}) cannot be scheduled")
            _prepared[key] = n


def _run_plan(x32: torch.Tensor, merge: bool) -> torch.Tensor:
    """Issue sort_plan(NP, P, merge) on x32 in one ctypes call; LAUNCHES
    adds the plan's kernel launches once the call has issued them all."""
    if not (x32.is_cuda and x32.dtype == torch.int32 and x32.dim() == 2
            and x32.is_contiguous() and x32.data_ptr() % 16 == 0):
        raise ValueError("bitonic kernel takes a contiguous, 16-byte aligned CUDA int32 "
                         "(planes, P) tensor")
    NP, P = x32.shape
    plan = sort_plan(int(NP), int(P), merge)
    with torch.cuda.device(x32.device):
        _prepare(plan, x32.device)
        desc = _descriptors(plan)
        stream = torch.cuda.current_stream(x32.device).cuda_stream
        _check(_lib().auron_bitonic_run(
            ctypes.c_void_p(x32.data_ptr()), plan.NP, plan.P, plan.tile, plan.cluster,
            plan.per_thread, desc, len(plan.launches), ctypes.c_void_p(stream)))
    for name, n in plan.launch_counts().items():
        if n:
            launch_count.add(LAUNCHES, _launch_lock, name, n)
    return x32


def kernel_sort_(x32: torch.Tensor) -> torch.Tensor:
    """Sort stacked int32 planes (NP, P) in place on the card, by the
    launches of ``sort_plan(NP, P)``."""
    return _run_plan(x32, merge=False)


def kernel_merge_(x32: torch.Tensor) -> torch.Tensor:
    """Merge stacked int32 planes holding one bitonic sequence, in place
    (the final stage, ``sort_plan(NP, P, merge=True)``)."""
    return _run_plan(x32, merge=True)


def _run(stacked: torch.Tensor, P: int, impl: str, merge: bool) -> torch.Tensor:
    """Sorted (or merged) planes (NP, P) of int64 carriers."""
    if impl == "pallas" and stacked.is_cuda:
        x32 = i32_of_u32(stacked).contiguous()
        (kernel_merge_ if merge else kernel_sort_)(x32)
        return u32_of_i32(x32)
    if impl == "pallas" and stacked.device.type != "cpu":
        raise RuntimeError(f"bitonic kernel: unsupported device {stacked.device}")
    return _merge_network(stacked, P) if merge else _network(stacked, P)


# ---------------------------------------------------------------------------
# public entry points (mirror auron_tpu.ops.bitonic)
# ---------------------------------------------------------------------------


def bitonic_sort(operands: tuple, *, impl: str = "jnp", narrow: tuple | None = None,
                 kinds: tuple | None = None) -> tuple:
    """Stable ascending sort of an operand tuple whose last operand is a
    distinct int32 payload (iota). ``kinds`` names each operand's word kind
    ('u64' | 'i64' | 'i32' | 'u32'); int64 defaults to 'u64', int32 to 'i32'."""
    if impl not in ("pallas", "jnp"):
        raise ValueError(f"bitonic impl {impl!r} (use lexsort for 'lax')")
    if narrow is None:
        narrow = (False,) * len(operands)
    if kinds is None:
        kinds = tuple(_default_kind(o) for o in operands)
    cap = operands[0].shape[0]
    P = max(_next_pow2(cap), 8 * _LANES)
    dev = operands[0].device
    if impl == "pallas" and dev.type == "cuda":
        planes32 = _split_planes32(operands, narrow, kinds)
        x32 = torch.full((len(planes32), P), -1, dtype=torch.int32, device=dev)
        x32[:, :cap] = torch.stack(planes32)  # padding (all ones) sorts last
        return _join_planes32(kernel_sort_(x32)[:, :cap], operands, narrow, kinds)
    planes = _split_planes(operands, narrow, kinds)
    stacked = torch.full((len(planes), P), MASK32, dtype=torch.int64, device=dev)
    stacked[:, :cap] = torch.stack(planes)
    out = _run(stacked, P, impl, merge=False)
    return _join_planes(out[:, :cap], operands, narrow, kinds)


def bitonic_merge(stacked: torch.Tensor, impl: str = "pallas") -> torch.Tensor:
    """Merge a bitonic sequence of stacked uint32 planes (NP, P), int64
    carriers, into ascending order — the counterpart of ``_merge_network``
    / the Pallas ``_merge_kernel``."""
    P = stacked.shape[1]
    return _run(stacked, P, impl, merge=True)


def merge_sorted_planes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bitonic merge of two ascending plane stacks ``(NP, na)`` and
    ``(NP, nb)`` with distinct columns: ``a``, then padding that sorts
    last, then ``b`` reversed is one bitonic sequence of P =
    next_pow2(na + nb) (at least 1,024) elements, which the final stage
    (k = P) sorts. On a CUDA tensor (int32 planes) that is K4,
    ``kernel_merge_``; on a CPU tensor (int64 carriers) the plain
    ``_merge_network``. Returns the first na + nb sorted columns."""
    NP, na = a.shape
    n = na + b.shape[1]
    P = max(_next_pow2(n), 8 * _LANES)
    if a.is_cuda:
        x = torch.full((NP, P), -1, dtype=torch.int32, device=a.device)
    elif a.device.type == "cpu":
        x = torch.full((NP, P), MASK32, dtype=torch.int64)
    else:
        raise RuntimeError(f"bitonic merge: unsupported device {a.device}")
    x[:, :na] = a
    x[:, P - b.shape[1]:] = b.flip(1)
    x = kernel_merge_(x) if a.is_cuda else _merge_network(x, P)
    return x[:, :n]


def merge_runs(runs: list[tuple], narrow: tuple, kinds: tuple) -> tuple:
    """Merge ascending runs of one operand layout, whose last operand is
    distinct across all runs, into one ascending operand tuple: the runs'
    planes merge pairwise, in a tree, by ``merge_sorted_planes`` — K4 on
    CUDA tensors (never the library sort), the plain network on CPU ones."""
    cuda = runs[0][0].is_cuda
    split = _split_planes32 if cuda else _split_planes
    stacks = [torch.stack(split(r, narrow, kinds)) for r in runs]
    while len(stacks) > 1:
        merged = [merge_sorted_planes(stacks[i], stacks[i + 1])
                  for i in range(0, len(stacks) - 1, 2)]
        stacks = merged + stacks[2 * len(merged):]
    return (_join_planes32 if cuda else _join_planes)(stacks[0], runs[0], narrow, kinds)


def lexsort(operands: tuple, kinds: tuple | None = None) -> torch.Tensor:
    """Stable ascending order (int64 permutation) of an operand tuple,
    operands[0] primary: one stable torch.sort pass per operand, least
    significant first. The library sort this port uses where the JAX
    package leaves the sort to ``lax.sort``."""
    if kinds is None:
        kinds = tuple(_default_kind(o) for o in operands)
    perm = None
    for op, kind in reversed(list(zip(operands, kinds))):
        key = flip(op) if kind == "u64" else op.to(torch.int64)
        if perm is not None:
            key = key[perm]
        idx = torch.sort(key, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return perm


def lex_sorted(operands: tuple, kinds: tuple | None = None) -> tuple:
    """The operands permuted by ``lexsort``; the payload comes out int32."""
    perm = lexsort(operands, kinds)
    return tuple(o[perm] for o in operands)


def ordered_sort(operands: tuple, word_narrow: tuple | None = None,
                 impl: str | None = None, conf=None) -> tuple:
    """ORDER-BY dispatch over ``(live, *order_words, iota)`` operands
    (exec/sort_exec.py): the bitonic kernels or the library lexsort."""
    n_words = len(operands) - 2
    if word_narrow is None:
        word_narrow = (False,) * n_words
    assert len(word_narrow) == n_words, (len(word_narrow), n_words)
    if impl is None:
        impl = sort_impl_for(n_words, operands[0].shape[0], sum(word_narrow), conf=conf,
                             device=operands[0].device)
    if impl in ("jnp", "pallas"):
        return bitonic_sort(operands, impl=impl, narrow=(True, *word_narrow, False))
    return lex_sorted(operands)


def sort_impl_for(n_words: int, cap: int, n_narrow_words: int = 1, conf=None,
                  device=None) -> str:
    """'lax' | 'jnp' | 'pallas' from exec.device.sort.impl; auto picks the
    CUDA kernels for CUDA tensors when P >= 2048 (the policy the JAX
    package applies on a TPU), the library lexsort otherwise."""
    mode = (conf if conf is not None else active_conf()).get(DEVICE_SORT_IMPL)
    if mode in ("lax", "jnp", "pallas"):
        return mode
    if device is None or torch.device(device).type != "cuda":
        return "lax"
    if max(_next_pow2(cap), 8 * _LANES) < _MIN_P:
        return "lax"
    return "pallas"

