"""The port's bitonic sort/merge against auron_tpu's Pallas kernels and
lax.sort, bit for bit (CPU: the port runs its plain torch network, the
reference runs its Pallas kernels in interpret mode where this jaxlib
supports it, else the same kernel bodies on host refs); plus the kernel
wrappers' device contract. The on-card checks are in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from auron_tpu.ops import bitonic as jb
from auron_tpu.utils.config import Configuration as JConf
from auron_tpu.utils.config import DEVICE_SORT_IMPL as J_IMPL

from auron_tpu_torch.ops import bitonic as pb
from auron_tpu_torch.ops import uwords as U
from auron_tpu_torch.utils.config import Configuration as PConf
from torch_carry import HostRef

_pallas_ok: list = []


def _pallas_interpret_works() -> bool:
    if not _pallas_ok:
        try:
            jb._run_pallas(jnp.zeros((1, 8, 128), jnp.uint32), 1024, True)
            _pallas_ok.append(True)
        except NotImplementedError:
            _pallas_ok.append(False)
    return _pallas_ok[0]


def ref_kernel_sort(x: jnp.ndarray, P: int) -> jnp.ndarray:
    """auron_tpu's _bitonic_kernel on (NP, P/128, 128) planes: through
    pallas_call in interpret mode, or the kernel body on host refs."""
    if _pallas_interpret_works():
        return jb._run_pallas(x, P, True)
    out = HostRef()
    jb._bitonic_kernel(HostRef(x), out, P=P)
    return out.v


def ref_kernel_merge(x: jnp.ndarray, P: int) -> jnp.ndarray:
    if _pallas_interpret_works():
        return jb._run_pallas_merge(x, P, True)
    out = HostRef()
    jb._merge_kernel(HostRef(x), out, P=P)
    return out.v


def _planes(rng, NP, P, tie_range):
    out = np.empty((NP, P), dtype=np.uint32)
    for p in range(NP - 1):
        out[p] = rng.integers(0, tie_range if p == 0 else 2**32, P, dtype=np.uint64)
    out[NP - 1] = np.arange(P, dtype=np.uint32)[rng.permutation(P)]
    return out


def _port(planes):
    return torch.from_numpy(planes.astype(np.int64))


def _ref(planes, P):
    return jnp.asarray(planes).reshape(planes.shape[0], P // 128, 128)


@pytest.mark.parametrize("P", [1024, 4096])
@pytest.mark.parametrize("NP,ties", [(2, 2**32), (3, 5), (5, 2), (8, 37)])
def test_network_matches_pallas_kernel_and_lax(P, NP, ties):
    planes = _planes(np.random.default_rng(P + NP), NP, P, ties)
    want_kernel = np.asarray(ref_kernel_sort(_ref(planes, P), P)).reshape(NP, P)
    got = pb._network(_port(planes), P).numpy()
    np.testing.assert_array_equal(got, want_kernel.astype(np.int64))
    want_lax = lax.sort(tuple(jnp.asarray(p) for p in planes), num_keys=NP)
    np.testing.assert_array_equal(got, np.stack([np.asarray(w) for w in want_lax]))


@pytest.mark.parametrize("P", [1024, 4096])
@pytest.mark.parametrize("NP", [2, 4, 8])
def test_merge_matches_pallas_merge_kernel(P, NP):
    """A bitonic sequence (ascending half ++ descending half) merges to the
    same planes as the reference's merge kernel and lax.sort."""
    planes = _planes(np.random.default_rng(7 * P + NP), NP, P, 3)
    half = P // 2
    a = planes[:, :half][:, np.lexsort(tuple(planes[::-1, :half]))]
    b = planes[:, half:][:, np.lexsort(tuple(planes[::-1, half:]))][:, ::-1]
    bit = np.ascontiguousarray(np.concatenate([a, b], axis=1))
    want = np.asarray(ref_kernel_merge(_ref(bit, P), P)).reshape(NP, P)
    got = pb.bitonic_merge(_port(bit), impl="pallas").numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(pb._merge_network(_port(bit), P).numpy(), got)
    want_lax = lax.sort(tuple(jnp.asarray(p) for p in planes), num_keys=NP)
    np.testing.assert_array_equal(got, np.stack([np.asarray(w) for w in want_lax]))


def _operands(cap, n_words, n_distinct, seed, dead_frac):
    rng = np.random.default_rng(seed)
    dead = (rng.random(cap) < dead_frac).astype(np.uint64)
    words = [rng.integers(0, n_distinct, cap).astype(np.uint64) for _ in range(n_words)]
    if n_words:
        words[0] = words[0] | (words[0] << np.uint64(33))
    return [dead, *words]


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("cap,n_words,n_distinct,dead_frac", [
    (1024, 1, 37, 0.0), (1024, 1, 5, 0.3), (2048, 2, 400, 0.1),
    (1500, 2, 64, 0.2), (4096, 3, 11, 0.5), (1024, 1, 1, 0.0),
])
def test_bitonic_sort_matches_reference(impl, cap, n_words, n_distinct, dead_frac):
    words = _operands(cap, n_words, n_distinct, cap + n_words, dead_frac)
    iota = np.arange(cap, dtype=np.int32)
    jops = (*[jnp.asarray(w) for w in words], jnp.asarray(iota))
    want = lax.sort(jops, num_keys=len(jops) - 1)
    want_j = jb.bitonic_sort(jops, impl="jnp")
    got = pb.bitonic_sort((*[U.from_u64_numpy(w, "cpu") for w in words], torch.from_numpy(iota)),
                          impl=impl)
    for w, wj, g in zip(want, want_j, got):
        gn = U.u64_numpy(g) if g.dtype == torch.int64 else g.numpy()
        np.testing.assert_array_equal(gn, np.asarray(w))
        np.testing.assert_array_equal(gn, np.asarray(wj))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_signed_and_narrow_operands(impl):
    rng = np.random.default_rng(21)
    cap = 2048
    k = rng.integers(-(2**62), 2**62, cap).astype(np.int64)
    v = rng.integers(-(2**30), 2**30, cap).astype(np.int32)
    d = (rng.random(cap) < 0.25).astype(np.uint64)
    w = rng.integers(0, 100, cap).astype(np.uint64)
    iota = np.arange(cap, dtype=np.int32)
    jops = (jnp.asarray(d), jnp.asarray(k), jnp.asarray(v), jnp.asarray(w), jnp.asarray(iota))
    want = lax.sort(jops, num_keys=4)
    got = pb.bitonic_sort(
        (U.from_u64_numpy(d, "cpu"), torch.from_numpy(k), torch.from_numpy(v),
         U.from_u64_numpy(w, "cpu"), torch.from_numpy(iota)),
        impl=impl, narrow=(True, False, False, True, False),
        kinds=("u64", "i64", "i32", "u64", "i32"),
    )
    np.testing.assert_array_equal(U.u64_numpy(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(U.u64_numpy(got[3]), np.asarray(want[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


@pytest.mark.parametrize("impl", ["lax", "jnp", "pallas"])
def test_ordered_sort_matches_reference(impl):
    rng = np.random.default_rng(5)
    cap = 3000
    live = (rng.random(cap) < 0.1).astype(np.uint64)
    nul = (rng.random(cap) < 0.2).astype(np.uint64)
    val = rng.integers(0, 50, cap).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    iota = np.arange(cap, dtype=np.int32)
    jops = tuple(jnp.asarray(a) for a in (live, nul, val, iota))
    want = jb.ordered_sort(jops, word_narrow=(True, False),
                           conf=JConf().set(J_IMPL, "lax" if impl == "lax" else "jnp"))
    got = pb.ordered_sort(
        (U.from_u64_numpy(live, "cpu"), U.from_u64_numpy(nul, "cpu"), U.from_u64_numpy(val, "cpu"),
         torch.from_numpy(iota)),
        word_narrow=(True, False), conf=PConf().set("exec.device.sort.impl", impl))
    for w, g in zip(want, got):
        gn = U.u64_numpy(g) if g.dtype == torch.int64 else g.numpy()
        np.testing.assert_array_equal(gn, np.asarray(w))


def test_sort_impl_policy():
    conf = PConf()
    assert pb.sort_impl_for(2, 16384, conf=conf, device="cpu") == "lax"
    assert pb.sort_impl_for(2, 16384, conf=conf, device="cuda") == "pallas"
    assert pb.sort_impl_for(2, 1000, conf=conf, device="cuda") == "lax"
    assert pb.sort_impl_for(2, 10, conf=PConf().set("exec.device.sort.impl", "pallas"),
                            device="cpu") == "pallas"


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA entry points take only CUDA int32 plane tensors; a CPU
    tensor never reaches a kernel (the public wrappers route it to the
    plain network instead, by device, never by catching a failure)."""
    x = torch.zeros((3, 1024), dtype=torch.int32)
    with pytest.raises(ValueError):
        pb.kernel_sort_(x)
    before = dict(pb.LAUNCHES)
    pb.bitonic_merge(torch.zeros((2, 1024), dtype=torch.int64), impl="pallas")
    assert pb.LAUNCHES == before


def test_tile_size_fits_shared_memory():
    """Every plan's tile fits a CTA's 227 KB of shared memory and every
    cluster Hopper's 16 CTAs (8 is the portable limit, 16 the measured
    faster one); the general kernels keep their 96 KB tiles."""
    for NP in range(1, 33):
        for L in range(7, 21):
            plan = pb.sort_plan(NP, 1 << L)
            T = plan.tile
            assert T & (T - 1) == 0 and T <= 2048 and plan.smem_bytes() <= 227 * 1024
            assert 1 <= plan.cluster <= 16 and (1 << L) % (T * plan.cluster) == 0
            if not plan.registers:
                assert T == pb.tile_for(NP, 1 << L) and plan.smem_bytes() <= 96 * 1024
        T = pb.tile_for(NP, 1 << 20)
        assert T & (T - 1) == 0 and NP * T * 4 <= 96 * 1024 and T <= 2048
    assert pb.tile_for(8, 1024) == 1024


def _network_substages(P, merge=False):
    out = []
    k = P if merge else 2
    while k <= P:
        j = k // 2
        while j >= 1:
            out.append((k, j))
            j //= 2
        k *= 2
    return out


@pytest.mark.parametrize("NP", [2, 8, 11, 16, 17])
def test_sort_plan_substages_are_the_network(NP):
    """The (k, j) substages of sort_plan's launches, in order, are exactly
    the network's, for the sort and for the final-stage merge."""
    for L in range(10, 21):
        P = 1 << L
        plan = pb.sort_plan(NP, P)
        assert plan.substages() == _network_substages(P), (NP, P)
        assert pb.sort_plan(NP, P, merge=True).substages() == _network_substages(P, True)
        counts = plan.launch_counts()
        assert counts["bitonic_sort"] == 1 and sum(counts.values()) == len(plan.launches)
        assert plan.registers == (NP <= pb._MAX_NP)


def test_sort_plan_main_path_shapes_are_one_launch():
    """q42's SortExec (16,384 x 8) and q3-mesh's collect sorts (16,384 and
    8,192 x 11) are one cluster launch each, over 16 CTAs."""
    for NP, P in ((8, 16384), (11, 16384), (11, 8192)):
        plan = pb.sort_plan(NP, P)
        assert [launch.kernel for launch in plan.launches] == ["cluster"]
        assert plan.cluster == 16 and plan.tile * plan.cluster == P
    big = pb.sort_plan(8, 1 << 20)
    assert [launch.kernel for launch in big.launches].count("cluster") == 1 + 5
    assert pb.sort_plan(8, 1 << 20, merge=True).launch_counts() == {
        "bitonic_sort": 0, "bitonic_merge": 3}


@pytest.mark.parametrize("NP,P", [(2, 1024), (8, 4096), (11, 2048), (17, 4096)])
def test_plan_grouping_equals_network(NP, P):
    """The plain substages run launch by launch as the plan groups them
    equal the plain _network and the JAX package's _network."""
    planes = _planes(np.random.default_rng(NP * P), NP, P, 3)
    x = _port(planes)
    flat = torch.arange(P)
    for launch in pb.sort_plan(NP, P).launches:
        for k, j in launch.substages():
            x = pb._substage(x, flat, k, j)
    np.testing.assert_array_equal(x.numpy(), pb._network(_port(planes), P).numpy())
    want = np.asarray(jb._network(_ref(planes, P), P)).reshape(NP, P)
    np.testing.assert_array_equal(x.numpy(), want.astype(np.int64))


# -- a numpy model of the kernels' index arithmetic (csrc/bitonic.cu) -------


def _lex_less(a, b):
    """a < b lexicographically over the plane axis 0 (numpy, any shape)."""
    lt = np.zeros(a.shape[1:], bool)
    eq = np.ones(a.shape[1:], bool)
    for p in range(a.shape[0]):
        lt |= eq & (a[p] < b[p])
        eq &= a[p] == b[p]
    return lt


def _order_groups(x, idx, desc):
    """order_group: groups idx (G, R) of element indices, each through its
    log2(R) register substages in the direction desc (G,); every element
    must be in exactly one group."""
    G, R = idx.shape
    assert np.array_equal(np.sort(idx.ravel()), np.arange(x.shape[1])), "groups must tile P"
    v = x[:, idx]
    bit = R // 2
    while bit >= 1:
        for m in range(R):
            if not m & bit:
                a, b = v[:, :, m].copy(), v[:, :, m | bit].copy()
                swap = _lex_less(a, b) == desc
                v[:, :, m] = np.where(swap, b, a)
                v[:, :, m | bit] = np.where(swap, a, b)
        bit //= 2
    x[:, idx] = v


def _insert_zero_bits(t, sh, M):
    return ((t >> sh) << (sh + M)) | (t & ((1 << sh) - 1))


def _model_cluster_launch(x, plan, launch):
    """bitonic_cluster's stage loop: cluster passes, tile passes, warp
    shuffles and register substages, with the kernel's own index math."""
    P, T, C, E = plan.P, plan.tile, plan.cluster, plan.per_thread
    span = C * T
    blocks = np.arange(P // T)
    k = launch.k_lo
    while k <= launch.k_hi:
        j = min(k // 2, span // 2)
        while j >= T:  # cluster_pass: q-th CTA of a group orders its share of offsets
            M = 2 if j >= 2 * T else 1
            R, j_lo = 1 << M, j >> (M - 1)
            rank, jr = blocks % C, j_lo // T
            q = (rank // jr) & (R - 1)
            t = np.arange(T // R)
            o = q[:, None] * (T // R) + t[None, :]
            tiles = (blocks - q * jr)[:, None] + jr * np.arange(R)[None, :]
            assert np.array_equal(tiles // C, np.repeat(blocks[:, None] // C, R, 1))
            idx = tiles[:, None, :] * T + o[:, :, None]
            lo0 = blocks * T - q * j_lo
            _order_groups(x, idx.reshape(-1, R), (((lo0[:, None] + o) & k) != 0).ravel())
            j >>= M
        while j >= 32 * E:  # tile_pass
            M = 2 if j >= 64 * E else 1
            R, j_lo = 1 << M, j >> (M - 1)
            b = _insert_zero_bits(np.arange(T // R), j_lo.bit_length() - 1, M)
            base = blocks[:, None] * T + b[None, :]
            idx = base[:, :, None] + j_lo * np.arange(R)[None, None, :]
            _order_groups(x, idx.reshape(-1, R), ((base & k) != 0).ravel())
            j >>= M
        g = np.arange(P)  # element g: thread g // E of tile g // T, register g % E
        while j >= E:  # __shfl_xor_sync: register r of lane ^ (j / E)
            tid, r = (g % T) // E, g % E
            partner = (g // T) * T + (tid ^ (j // E)) * E + r
            want_max = ((g & j) != 0) != ((g & k) != 0)
            take = _lex_less(x, x[:, partner]) == want_max
            x = np.where(take, x[:, partner], x)
            j //= 2
        while j >= 1:  # registers
            lo = g[(g & j) == 0]
            _order_groups(x, np.stack([lo, lo | j], 1), (lo & k) != 0)
            j //= 2
        k *= 2
    return x


def _model_run(x, plan):
    """The plan's launches over numpy planes (NP, P), the register kernels
    with their index math; the general kernels as plain substages."""
    x = x.copy()
    for launch in plan.launches:
        if launch.kernel == "cluster":
            x = _model_cluster_launch(x, plan, launch)
        elif launch.kernel == "strides":  # bitonic_strides: thread q holds 2^M registers
            M = (launch.j_hi // launch.j_lo).bit_length()
            b = _insert_zero_bits(np.arange(plan.P >> M), launch.j_lo.bit_length() - 1, M)
            idx = b[:, None] + launch.j_lo * np.arange(1 << M)[None, :]
            _order_groups(x, idx, (b & launch.k_lo) != 0)
        else:
            flat = torch.arange(plan.P)
            t = torch.from_numpy(x)
            for k, j in launch.substages():
                t = pb._substage(t, flat, k, j)
            x = t.numpy().copy()
    return x


@pytest.mark.parametrize("NP", [2, 8, 11, 16])
@pytest.mark.parametrize("P", [128, 256, 1024, 2048, 8192, 16384, 65536])
def test_kernel_index_model_sorts(NP, P):
    """The kernels' index arithmetic, run as numpy over each launch of the
    plan: every pass covers all P elements once, cluster groups stay inside
    their cluster, and the result is the lexsort (sort) and the merged
    bitonic sequence (merge), ties and padding-like duplicates included."""
    rng = np.random.default_rng(NP + P)
    planes = _planes(rng, NP, P, 3).astype(np.int64)
    planes[: NP - 1, : P // 8] = 0  # a run of equal keys (distinct payloads)
    planes[:, P - 3:] = (1 << 32) - 1  # identical padding elements, as bitonic_sort pads
    want = planes[:, np.lexsort(tuple(planes[::-1]))]
    np.testing.assert_array_equal(_model_run(planes, pb.sort_plan(NP, P)), want)
    half = P // 2
    a = planes[:, :half][:, np.lexsort(tuple(planes[::-1, :half]))]
    b = planes[:, half:][:, np.lexsort(tuple(planes[::-1, half:]))][:, ::-1]
    bit = np.ascontiguousarray(np.concatenate([a, b], axis=1))
    np.testing.assert_array_equal(_model_run(bit, pb.sort_plan(NP, P, merge=True)), want)
