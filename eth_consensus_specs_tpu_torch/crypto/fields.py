"""BLS12-381 field towers: Fq, Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - xi),
Fq12 = Fq6[w]/(w^2 - v), with xi = 1 + u.

The port's copy of ``eth_consensus_specs_tpu/crypto/fields.py``, pure
Python. Elements are immutable; operators are overloaded so the curve and
pairing code is generic over the tower. Frobenius constants are computed
at import (gamma_i = xi^(i*(p-1)/6)). Inversion uses Python's modular
inverse (``pow(n, -1, P)``), which returns the same element as the Fermat
power the JAX package's pure path takes.
"""

from __future__ import annotations

# Base field modulus (public BLS12-381 parameter)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F624_1EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Subgroup order
R = 0x73EDA753299D7D483339D80809A1D805_53BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (loop count); negative for BLS12-381
BLS_X = -0xD201000000010000


class Fq:
    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % P

    def __add__(self, o):
        return Fq(self.n + o.n)

    def __sub__(self, o):
        return Fq(self.n - o.n)

    def __mul__(self, o):
        return Fq(self.n * o.n)

    def __neg__(self):
        return Fq(-self.n)

    def inv(self):
        if self.n == 0:
            raise ZeroDivisionError("Fq inverse of zero")
        return Fq(pow(self.n, -1, P))

    def square(self):
        return Fq(self.n * self.n)

    def is_zero(self):
        return self.n == 0

    def __eq__(self, o):
        return isinstance(o, Fq) and o.n == self.n

    def __hash__(self):
        return hash(("Fq", self.n))

    def sqrt(self):
        """Square root (p % 4 == 3 branch). Returns None if non-residue."""
        c = pow(self.n, (P + 1) // 4, P)
        if c * c % P == self.n:
            return Fq(c)
        return None

    def sign(self) -> int:
        """Lexicographic 'largest' flag: 1 if n > (P-1)/2."""
        return 1 if self.n > (P - 1) // 2 else 0

    @staticmethod
    def zero():
        return Fq(0)

    @staticmethod
    def one():
        return Fq(1)

    def __repr__(self):
        return f"Fq(0x{self.n:x})"


class Fq2:
    """c0 + c1*u with u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq, c1: Fq):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def from_ints(a: int, b: int) -> "Fq2":
        return Fq2(Fq(a), Fq(b))

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o):
        a = self.c0.n * o.c0.n
        b = self.c1.n * o.c1.n
        cross = (self.c0.n + self.c1.n) * (o.c0.n + o.c1.n) - a - b
        return Fq2(Fq(a - b), Fq(cross))

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def square(self):
        a0, a1 = self.c0.n, self.c1.n
        return Fq2(Fq((a0 + a1) * (a0 - a1)), Fq(2 * a0 * a1))

    def conjugate(self):
        return Fq2(self.c0, -self.c1)

    def inv(self):
        norm = self.c0.square() + self.c1.square()
        ninv = norm.inv()
        return Fq2(self.c0 * ninv, -(self.c1 * ninv))

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, o):
        return isinstance(o, Fq2) and o.c0 == self.c0 and o.c1 == self.c1

    def __hash__(self):
        return hash(("Fq2", self.c0.n, self.c1.n))

    def pow(self, e: int):
        result = Fq2.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def sqrt(self):
        """Square root in Fq2 via the norm method; None if non-residue."""
        if self.is_zero():
            return Fq2.zero()
        a, b = self.c0, self.c1
        if b.is_zero():
            s = a.sqrt()
            if s is not None:
                return Fq2(s, Fq.zero())
            # sqrt(a) = sqrt(-a) * u  since u^2 = -1
            s = (-a).sqrt()
            assert s is not None
            return Fq2(Fq.zero(), s)
        norm = a.square() + b.square()  # N(a+bu) = a^2 + b^2
        sn = norm.sqrt()
        if sn is None:
            return None
        # x = sqrt((a + sn)/2); if not square, try (a - sn)/2
        inv2 = Fq((P + 1) // 2)
        for s in (sn, -sn):
            half = (a + s) * inv2
            x = half.sqrt()
            if x is not None and not x.is_zero():
                y = b * (x + x).inv()
                cand = Fq2(x, y)
                if cand.square() == self:
                    return cand
        return None

    def sign(self) -> int:
        """Lexicographic largest: compare c1 first, then c0 (serialization
        convention: imaginary limb is most significant)."""
        if self.c1.n != 0:
            return 1 if self.c1.n > (P - 1) // 2 else 0
        return 1 if self.c0.n > (P - 1) // 2 else 0

    @staticmethod
    def zero():
        return Fq2(Fq.zero(), Fq.zero())

    @staticmethod
    def one():
        return Fq2(Fq.one(), Fq.zero())

    def __repr__(self):
        return f"Fq2(0x{self.c0.n:x}, 0x{self.c1.n:x})"


# Non-residue used to build Fq6: xi = 1 + u
XI = Fq2.from_ints(1, 1)


class Fq6:
    """c0 + c1*v + c2*v^2 with v^3 = xi."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2) * XI
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2 * XI
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_xi_shift(self):
        """Multiply by v (the Fq6 'shift'): (c0,c1,c2) -> (c2*xi, c0, c1)."""
        return Fq6(self.c2 * XI, self.c0, self.c1)

    def inv(self):
        a, b, c = self.c0, self.c1, self.c2
        t0 = a.square() - b * c * XI
        t1 = c.square() * XI - a * b
        t2 = b.square() - a * c
        denom = (a * t0 + (c * t1 + b * t2) * XI).inv()
        return Fq6(t0 * denom, t1 * denom, t2 * denom)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o):
        return isinstance(o, Fq6) and o.c0 == self.c0 and o.c1 == self.c1 and o.c2 == self.c2

    def __hash__(self):
        return hash(("Fq6", self.c0, self.c1, self.c2))

    @staticmethod
    def zero():
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one():
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())


class Fq12:
    """c0 + c1*w with w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        a = self.c0 * o.c0
        b = self.c1 * o.c1
        cross = (self.c0 + self.c1) * (o.c0 + o.c1) - a - b
        return Fq12(a + b.mul_by_xi_shift(), cross)

    def square(self):
        return self * self

    def conjugate(self):
        """f^(p^6): negate the w-odd half."""
        return Fq12(self.c0, -self.c1)

    def inv(self):
        t = (self.c0.square() - self.c1.square().mul_by_xi_shift()).inv()
        return Fq12(self.c0 * t, -(self.c1 * t))

    def pow(self, e: int):
        if e < 0:
            return self.inv().pow(-e)
        result = Fq12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def is_one(self):
        return self == Fq12.one()

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, o):
        return isinstance(o, Fq12) and o.c0 == self.c0 and o.c1 == self.c1

    def __hash__(self):
        return hash(("Fq12", self.c0, self.c1))

    @staticmethod
    def zero():
        return Fq12(Fq6.zero(), Fq6.zero())

    @staticmethod
    def one():
        return Fq12(Fq6.one(), Fq6.zero())

    # -- flattened coefficient view: f = sum_{i=0}^{5} a_i w^i, a_i in Fq2 --

    def coeffs(self) -> list[Fq2]:
        return [self.c0.c0, self.c1.c0, self.c0.c1, self.c1.c1, self.c0.c2, self.c1.c2]

    @staticmethod
    def from_coeffs(a: list[Fq2]) -> "Fq12":
        return Fq12(Fq6(a[0], a[2], a[4]), Fq6(a[1], a[3], a[5]))

    def frobenius(self) -> "Fq12":
        """f -> f^p using computed gamma constants."""
        return Fq12.from_coeffs(
            [c.conjugate() * FROB_GAMMA[i] for i, c in enumerate(self.coeffs())]
        )

    def ints(self) -> list[int]:
        """The 12 canonical Fq values in the layout [half][v][u] (half of
        w, power of v, component of u): the order the port's limb tensors
        use."""
        return [c.n for half in (self.c0, self.c1) for e in (half.c0, half.c1, half.c2)
                for c in (e.c0, e.c1)]

    @staticmethod
    def from_ints(vals) -> "Fq12":
        v = [int(x) for x in vals]
        e = [Fq2.from_ints(v[2 * i], v[2 * i + 1]) for i in range(6)]
        return Fq12(Fq6(e[0], e[1], e[2]), Fq6(e[3], e[4], e[5]))


# gamma_i = xi^(i*(p-1)/6): the w^i Frobenius twist constants
FROB_GAMMA = [XI.pow(i * (P - 1) // 6) for i in range(6)]
# gamma2_i = xi^(i*(p^2-1)/6), which lie in Fq: the f -> f^(p^2) constants
FROB2_GAMMA = [XI.pow(i * (P * P - 1) // 6) for i in range(6)]
