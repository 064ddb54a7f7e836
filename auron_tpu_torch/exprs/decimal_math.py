"""Checked decimal64 arithmetic on torch int64 tensors.

Port of ``auron_tpu/exprs/decimal_math.py``. Decimals are scaled int64
(``types.py``); Spark's non-ANSI overflow contract is overflow -> NULL, so
every helper returns ``(values, ok_mask)`` and the evaluator folds failures
into validity. Rounding is java.math.RoundingMode.HALF_UP (Spark's decimal
division and rescale-down): truncating division plus a half-adjust, no
floats in the value path; float64 magnitudes only *detect* a would-be
int64 overflow.

``lax.div``/``lax.rem`` truncate toward zero: here they are
``torch.div(..., rounding_mode="trunc")`` and ``torch.fmod``, never ``//``
and ``%`` (which floor). Integer division by zero, and INT64_MIN / -1,
trap (SIGFPE) on a CPU, where ``lax.div`` returns INT64_MIN for the
latter: every column divisor goes through ``_safe_divisor`` first, which
gives the same quotient and remainder on every lane that does not fail.
"""

from __future__ import annotations

import torch

_POW10 = [10**i for i in range(19)]
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def pow10(k: int) -> int:
    assert 0 <= k <= 18, k
    return _POW10[k]


def _ones(v: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(v, dtype=torch.bool)


def tdiv(a: torch.Tensor, b) -> torch.Tensor:
    """``lax.div``: int64 division truncating toward zero (``b`` nonzero and
    not -1 where ``a`` is INT64_MIN; see ``_safe_divisor``)."""
    return torch.div(a, b, rounding_mode="trunc")


def _safe_divisor(num: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(divisor safe to divide ``num`` by, b == 0). A zero divisor becomes 1
    (the lane is NULL anyway); INT64_MIN / -1 divides by 1 instead, which
    gives ``lax.div``'s INT64_MIN and ``lax.rem``'s 0 without the trap."""
    bz = b == 0
    trap = (b == -1) & (num == _I64_MIN)
    return torch.where(bz | trap, torch.ones_like(b), b), bz


def checked_mul_pow10(v: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """v * 10^k with overflow detection."""
    if k == 0:
        return v, _ones(v)
    if k > 18:
        return torch.zeros_like(v), torch.zeros_like(v, dtype=torch.bool)
    limit = _I64_MAX // pow10(k)
    return v * pow10(k), torch.abs(v) <= limit


def rescale(v: torch.Tensor, from_scale: int, to_scale: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Change scale with HALF_UP rounding on scale-down."""
    if to_scale == from_scale:
        return v, _ones(v)
    if to_scale > from_scale:
        return checked_mul_pow10(v, to_scale - from_scale)
    k = from_scale - to_scale
    if k > 18:
        return torch.zeros_like(v), _ones(v)
    p = pow10(k)
    q = tdiv(v, p)
    r = torch.fmod(v, p)
    half = p // 2
    # HALF_UP: |r| >= p/2 rounds away from zero (p is even for k >= 1)
    adj = (r >= half).to(v.dtype) - (r <= -half).to(v.dtype)
    return q + adj, _ones(v)


def precision_ok(v: torch.Tensor, precision: int) -> torch.Tensor:
    """Spark CheckOverflow: |v| must fit in ``precision`` digits."""
    if precision >= 19:
        return _ones(v)  # the int64 range is the only bound
    return torch.abs(v) < pow10(precision)


def add(a, sa: int, b, sb: int, out_prec: int, out_scale: int):
    av, aok = rescale(a, sa, out_scale)
    bv, bok = rescale(b, sb, out_scale)
    s = av + bv
    # int64 wraparound of the sum
    wrap_ok = ~(((av > 0) & (bv > 0) & (s < 0)) | ((av < 0) & (bv < 0) & (s > 0)))
    return s, aok & bok & wrap_ok & precision_ok(s, out_prec)


def sub(a, sa: int, b, sb: int, out_prec: int, out_scale: int):
    return add(a, sa, -b, sb, out_prec, out_scale)


def mul(a, sa: int, b, sb: int, out_prec: int, out_scale: int):
    prod = a * b  # scale sa + sb (wraps where the estimate says no)
    est = torch.abs(a.to(torch.float64) * b.to(torch.float64))
    no_wrap = est < 9.0e18
    v, rok = rescale(prod, sa + sb, out_scale)
    return v, no_wrap & rok & precision_ok(v, out_prec)


def div(a, sa: int, b, sb: int, out_prec: int, out_scale: int):
    """HALF_UP division; divisor 0 -> not ok (Spark returns NULL).
    a/10^sa / (b/10^sb) * 10^s = a * 10^(s - sa + sb) / b."""
    k = out_scale - sa + sb
    if k >= 0:
        num, nok = checked_mul_pow10(a, k)
        bsafe, bz = _safe_divisor(num, b)
        q = tdiv(num, bsafe)
        r = torch.fmod(num, bsafe)
        adj = torch.where(2 * torch.abs(r) >= torch.abs(bsafe),
                          torch.sign(num) * torch.sign(bsafe), torch.zeros_like(q))
        v = q + adj
    else:
        # negative k: divide, then rescale down
        bsafe, bz = _safe_divisor(a, b)
        q = tdiv(a, bsafe)
        r = torch.fmod(a, bsafe)
        adj = torch.where(2 * torch.abs(r) >= torch.abs(bsafe),
                          torch.sign(a) * torch.sign(bsafe), torch.zeros_like(q))
        v, nok = rescale(q + adj, -k, 0)
    return v, nok & ~bz & precision_ok(v, out_prec)


def mod(a, sa: int, b, sb: int, out_prec: int, out_scale: int):
    s = max(sa, sb)
    av, aok = rescale(a, sa, s)
    bv, bok = rescale(b, sb, s)
    bsafe, bz = _safe_divisor(av, bv)
    r = torch.fmod(av, bsafe)  # keeps the dividend's sign
    v, rok = rescale(r, s, out_scale)
    return v, aok & bok & rok & ~bz & precision_ok(v, out_prec)
