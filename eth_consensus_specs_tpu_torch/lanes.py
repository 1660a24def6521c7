"""u32/u64 arithmetic carried in signed torch lanes.

u64 values live in ``torch.int64`` with the same bits; add, subtract,
multiply, xor, and, or and equality already agree bit for bit with the
unsigned operations (two's complement wraps the same way). Order compares
and division do not, and are given here. u32 SHA words are handled in
int64 lanes holding values in ``[0, 2**32)``, masked after every operation
that can carry out of 32 bits.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_SIGN64 = -(1 << 63)  # the int64 bit pattern of 2**63
_MAX63 = (1 << 63) - 1


def mask32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 lane, as a non-negative int64."""
    return x & MASK32


def rotr32(x, n: int):
    """Rotate right a u32 value held in ``[0, 2**32)`` of an int64 lane
    (or a Python int)."""
    return ((x >> n) | (x << (32 - n))) & MASK32


def bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte-swap u32 values held in ``[0, 2**32)`` of an int64 lane."""
    return (
        ((x & 0xFF) << 24)
        | ((x & 0xFF00) << 8)
        | ((x >> 8) & 0xFF00)
        | ((x >> 24) & 0xFF)
    )


def to_u32_lanes(words: torch.Tensor) -> torch.Tensor:
    """int32 word carrier -> int64 lanes holding the unsigned value."""
    return words.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding u32 values -> the int32 word carrier (same bits)."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def ult64(a, b) -> torch.Tensor:
    """Unsigned ``a < b`` on the u64 bits of int64 lanes."""
    return torch.as_tensor(a ^ _SIGN64) < torch.as_tensor(b ^ _SIGN64)


def ule64(a, b) -> torch.Tensor:
    """Unsigned ``a <= b`` on the u64 bits of int64 lanes."""
    return ~ult64(b, a)


def umin64(a, b) -> torch.Tensor:
    return torch.where(ult64(a, b), a, b)


def umax64(a, b) -> torch.Tensor:
    return torch.where(ult64(a, b), b, a)


def udiv64(a, b) -> torch.Tensor:
    """Unsigned floor division of u64 bits, for divisors ``0 < b < 2**63``.

    Halving the dividend with a logical shift keeps it below 2**63, where
    signed and unsigned division agree; the dropped bit leaves a remainder
    below ``2*b``, which one correction step absorbs."""
    a = torch.as_tensor(a)
    q = (((a >> 1) & _MAX63) // b) << 1
    r = a - q * b
    return q + ule64(b, r).to(torch.int64)


def umod64(a, b) -> torch.Tensor:
    """Unsigned ``a % b`` for divisors ``0 < b < 2**63``."""
    return a - udiv64(a, b) * b
