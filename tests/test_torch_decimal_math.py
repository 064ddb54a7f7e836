"""The port's checked decimal64 kernels (``auron_tpu_torch/exprs/
decimal_math.py``) against the JAX package's (``auron_tpu/exprs/
decimal_math.py``) on the same seeded int64 operands, bit for bit: values
and ok masks. The operands hold the edge cases: INT64_MIN and INT64_MAX,
-1 and 0 divisors, HALF_UP ties of both signs, values at the precision
boundary."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auron_tpu.exprs import decimal_math as JD

from auron_tpu_torch.exprs import decimal_math as PD

I64_MIN, I64_MAX = -(2**63), 2**63 - 1
N = 4000


def _operands(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, -1, 5, -5, 15, -15, 25, -25, 50, -50, 149, -149, 150, -150,
                     10**17 - 1, -(10**17) + 1, 10**18 - 1, -(10**18) + 1, 10**18, -(10**18),
                     I64_MIN, I64_MAX, I64_MIN + 1, 3037000499, -3037000500], dtype=np.int64)
    mags = 10 ** rng.integers(0, 19, N - len(edge))
    vals = rng.integers(-(2**62), 2**62, N - len(edge)) % np.maximum(mags, 1)
    signs = rng.choice([-1, 1], N - len(edge))
    return np.concatenate([edge, (vals * signs).astype(np.int64)])


def _both(fn_name: str, *args):
    jv, jok = getattr(JD, fn_name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                     for a in args])
    pv, pok = getattr(PD, fn_name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                     for a in args])
    return (np.asarray(jv), np.asarray(jok)), (pv.numpy(), pok.numpy())


def _assert_same(j, p, label):
    (jv, jok), (pv, pok) = j, p
    np.testing.assert_array_equal(pok, jok, err_msg=f"{label} ok")
    np.testing.assert_array_equal(np.where(jok, pv, 0), np.where(jok, jv, 0),
                                  err_msg=f"{label} values")


@pytest.mark.parametrize("k", [0, 1, 2, 5, 17, 18, 19])
def test_checked_mul_pow10(k):
    a = _operands(k)
    _assert_same(*_both("checked_mul_pow10", a, k), f"mul_pow10 {k}")


@pytest.mark.parametrize("src,dst", [(2, 2), (2, 4), (4, 2), (6, 0), (3, 1), (0, 18),
                                     (19, 0), (2, 0)])
def test_rescale_half_up(src, dst):
    a = _operands(100 + src * 7 + dst)
    (jv, jok), (pv, pok) = _both("rescale", a, src, dst)
    np.testing.assert_array_equal(pok, jok)
    np.testing.assert_array_equal(pv[jok], jv[jok])


def test_rescale_ties_round_half_up_both_signs():
    v = torch.tensor([15, -15, 25, -25, 14, -14, 16, -16, 5, -5], dtype=torch.int64)
    got, ok = PD.rescale(v, 1, 0)
    assert got.tolist() == [2, -2, 3, -3, 1, -1, 2, -2, 1, -1]
    assert ok.all()


@pytest.mark.parametrize("p", [1, 7, 17, 18, 19])
def test_precision_ok(p):
    a = _operands(200 + p)
    j = np.asarray(JD.precision_ok(jnp.asarray(a), p))
    np.testing.assert_array_equal(PD.precision_ok(torch.from_numpy(a), p).numpy(), j)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "mod"])
@pytest.mark.parametrize("sa,sb,prec,scale", [(2, 2, 18, 2), (2, 0, 18, 6), (4, 1, 18, 5),
                                              (0, 3, 10, 3), (6, 6, 18, 12), (2, 4, 9, 0)])
def test_binary_ops(op, sa, sb, prec, scale):
    a = _operands(300 + sa)
    b = np.roll(_operands(400 + sb), 7)
    b[:40] = np.resize(np.array([0, -1, 1, 0, -1], dtype=np.int64), 40)  # 0 and -1 divisors
    a[:8] = I64_MIN
    _assert_same(*_both(op, a, sa, b, sb, prec, scale), f"{op} {sa},{sb}->{prec},{scale}")


def test_int64_min_over_minus_one_does_not_trap():
    """lax.div(INT64_MIN, -1) is INT64_MIN: on a CPU the port's guarded
    divisor gives the same instead of a SIGFPE."""
    a = torch.tensor([I64_MIN, I64_MIN, 7], dtype=torch.int64)
    b = torch.tensor([-1, 0, 0], dtype=torch.int64)
    v, ok = PD.div(a, 0, b, 0, 19, 0)
    assert v[0].item() == I64_MIN and ok.tolist() == [True, False, False]
    m, mok = PD.mod(a, 0, b, 0, 19, 0)
    assert m[0].item() == 0 and mok.tolist() == [True, False, False]
