"""Bitonic cluster sort: the engine's sort primitive, CUDA kernels + plain torch.

Port of ``auron_tpu/ops/bitonic.py``. The operands of a stable multi-key
sort (key words + a distinct int32 payload as the last operand) split into
uint32 planes, most significant first; the payload is the last compare
plane, so the order is total and the bitonic network's result equals the
stable sort it replaces (``lax.sort(ops, num_keys=n-1)`` in the JAX
package, a stable multi-pass ``torch.sort`` here).

Two implementations of the same network:

- the CUDA kernels in ``csrc/bitonic.cu`` (route: nvcc + ctypes): a tile
  sort in shared memory (``_launch_block_sort``, replacing the Pallas
  ``_bitonic_kernel``) and one merge stage (``_launch_merge_stage``,
  replacing the Pallas ``_merge_kernel``). A sort of P > T elements is the
  tile sort followed by merge stages k = 2T .. P;
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
import threading

import torch

from auron_tpu_torch.ops.uwords import MASK32, flip, hi32, i32_of_u32, join32, lo32, u32_of_i32
from auron_tpu_torch.utils.config import DEVICE_SORT_IMPL, active_conf

_LANES = 128
_MIN_P = 2048  # auto: below this the network is not worth its setup
_SMEM_TILE_BYTES = 96 * 1024  # shared memory per CTA the tile may use
_MAX_TILE = 2048  # 1024 threads x one pair each per substage

#: launch counts, one per kernel-wrapper call that launched its kernel
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

_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from auron_tpu_torch.ops import cuda_build

        lib = cuda_build.load("bitonic")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.auron_bitonic_block_sort.argtypes = [vp, ci, cll, ci, vp]
        lib.auron_bitonic_block_sort.restype = ci
        lib.auron_bitonic_merge_stage.argtypes = [vp, ci, cll, ci, cll, vp]
        lib.auron_bitonic_merge_stage.restype = ci
        lib.auron_cuda_error_string.argtypes = [ci]
        lib.auron_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def tile_for(n_planes: int, P: int) -> int:
    """Elements per CTA tile: the largest power of two <= _MAX_TILE whose
    planes fit the shared-memory budget, capped at P."""
    T = _MAX_TILE
    while T > 2 and n_planes * T * 4 > _SMEM_TILE_BYTES:
        T //= 2
    return min(T, P)


def _check(rc: int) -> None:
    if rc != 0:
        msg = _lib().auron_cuda_error_string(rc).decode()
        raise RuntimeError(f"bitonic CUDA kernel failed: error {rc} ({msg})")


def _kernel_args(x32: torch.Tensor):
    if not (x32.is_cuda and x32.dtype == torch.int32 and x32.dim() == 2
            and x32.is_contiguous()):
        raise ValueError("bitonic kernel takes a contiguous CUDA int32 (planes, P) tensor")
    NP, P = x32.shape
    if P < 2 or P & (P - 1):
        raise ValueError(f"bitonic kernel needs a power-of-two length, got {P}")
    stream = torch.cuda.current_stream(x32.device).cuda_stream
    return ctypes.c_void_p(x32.data_ptr()), int(NP), int(P), ctypes.c_void_p(stream)


def _launch_block_sort(x32: torch.Tensor, T: int) -> None:
    ptr, NP, P, stream = _kernel_args(x32)
    _check(_lib().auron_bitonic_block_sort(ptr, NP, P, T, stream))
    with _launch_lock:
        LAUNCHES["bitonic_sort"] += 1


def _launch_merge_stage(x32: torch.Tensor, T: int, k: int) -> None:
    ptr, NP, P, stream = _kernel_args(x32)
    _check(_lib().auron_bitonic_merge_stage(ptr, NP, P, T, k, stream))
    with _launch_lock:
        LAUNCHES["bitonic_merge"] += 1


def kernel_sort_(x32: torch.Tensor) -> torch.Tensor:
    """Sort stacked int32 planes (NP, P) in place on the card: the tile
    sort, then merge stages k = 2T .. P."""
    NP, P = x32.shape
    T = tile_for(NP, P)
    with torch.cuda.device(x32.device):
        _launch_block_sort(x32, T)
        k = 2 * T
        while k <= P:
            _launch_merge_stage(x32, T, k)
            k *= 2
    return x32


def kernel_merge_(x32: torch.Tensor) -> torch.Tensor:
    """Merge stacked int32 planes holding one bitonic sequence, in place."""
    NP, P = x32.shape
    with torch.cuda.device(x32.device):
        _launch_merge_stage(x32, tile_for(NP, P), P)
    return x32


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

