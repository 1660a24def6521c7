"""BLS12-381 curve groups.

E1: y^2 = x^3 + 4        over Fq   (G1; 48-byte compressed points)
E2: y^2 = x^3 + 4(1+u)   over Fq2  (G2; 96-byte compressed points, M-twist)

The port's copy of ``eth_consensus_specs_tpu/crypto/curve.py``. Points are
immutable affine pairs (None = infinity). Scalar multiplication and the
subgroup checks run in Jacobian coordinates on plain ints (G1) and int pairs
(G2), with no inversion per step, the algorithm of the JAX package's C core
(``native/bls12_381.c``): G1 membership is r*P = O, G2 membership is
Bowe's criterion psi(Q) = -[|x|]Q. Serialization is the standard
compressed encoding (flag bits: compressed, infinity, largest y).
"""

from __future__ import annotations

from .fields import BLS_X, Fq, Fq2, P, R, XI

B1 = Fq(4)
B2 = Fq2.from_ints(4, 4)

# Public generator coordinates (standard BLS12-381 parameters)
G1_GEN = (
    Fq(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB),
    Fq(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
)
G2_GEN = (
    Fq2(
        Fq(0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8),
        Fq(0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    ),
    Fq2(
        Fq(0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801),
        Fq(0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
    ),
)
BLS_X_ABS = -BLS_X


class Point:
    """Affine point on y^2 = x^3 + b over a tower field; None coords = O.

    ``row`` is the point's row for the card: x then y, each Fq coordinate
    in the kernels' Montgomery form c * 2^384 mod p as 12 little-endian u32
    limbs (a G1 row is 96 bytes; a G2 row 192, each Fq2 as c0 then c1). It
    is made once and kept with the point, so that a batch of cached public
    keys or signatures packs for the card without touching Python ints."""

    __slots__ = ("x", "y", "b", "_row")

    def __init__(self, x, y, b):
        self.x, self.y, self.b = x, y, b
        self._row = None

    @staticmethod
    def infinity(b):
        return Point(None, None, b)

    def is_infinity(self) -> bool:
        return self.x is None

    def is_on_curve(self) -> bool:
        if self.is_infinity():
            return True
        return self.y.square() == self.x.square() * self.x + self.b

    @property
    def row(self) -> bytes:
        if self._row is None:
            if self.is_infinity():
                self._row = bytes(96 if self.b == B1 else 192)
            else:
                coords = (self.x, self.y) if isinstance(self.x, Fq) else (
                    self.x.c0, self.x.c1, self.y.c0, self.y.c1)
                self._row = b"".join(((c.n << 384) % P).to_bytes(48, "little") for c in coords)
        return self._row

    def __eq__(self, o):
        if not isinstance(o, Point):
            return NotImplemented
        if self.is_infinity() or o.is_infinity():
            return self.is_infinity() and o.is_infinity()
        return self.x == o.x and self.y == o.y

    def __hash__(self):
        return hash((None, None) if self.is_infinity() else (self.x, self.y))

    def __neg__(self):
        if self.is_infinity():
            return self
        return Point(self.x, -self.y, self.b)

    def __add__(self, o: "Point") -> "Point":
        if self.is_infinity():
            return o
        if o.is_infinity():
            return self
        if self.x == o.x:
            if self.y == o.y:
                return self.double()
            return Point.infinity(self.b)
        lam = (o.y - self.y) * (o.x - self.x).inv()
        x3 = lam.square() - self.x - o.x
        y3 = lam * (self.x - x3) - self.y
        return Point(x3, y3, self.b)

    def double(self) -> "Point":
        if self.is_infinity() or self.y.is_zero():
            return Point.infinity(self.b)
        x_sq = self.x.square()
        lam = (x_sq + x_sq + x_sq) * (self.y + self.y).inv()
        x3 = lam.square() - self.x - self.x
        y3 = lam * (self.x - x3) - self.y
        return Point(x3, y3, self.b)

    def __sub__(self, o):
        return self + (-o)

    def mul(self, k: int) -> "Point":
        """Scalar multiplication by double-and-add in Jacobian coordinates."""
        k = int(k)
        if k < 0:
            return (-self).mul(-k)
        if k == 0 or self.is_infinity():
            return Point.infinity(self.b)
        F = _field_of(self)
        return F.to_point(jac_mul(F, F.from_point(self), k), self.b)

    def __repr__(self):
        if self.is_infinity():
            return "Point(infinity)"
        return f"Point({self.x!r}, {self.y!r})"


# --- Jacobian arithmetic over raw field values --------------------------------
# A field is a namespace of functions on raw values: ints for Fq, (c0, c1)
# int pairs for Fq2. A Jacobian point is (X, Y, Z); Z = 0 is infinity.


class F1:
    zero, one = 0, 1

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def sqr(a):
        return a * a % P

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def neg(a):
        return -a % P

    @staticmethod
    def is_zero(a):
        return a == 0

    @staticmethod
    def inv(a):
        return pow(a, -1, P)

    @staticmethod
    def from_point(p):
        return (p.x.n, p.y.n, 1)

    @staticmethod
    def to_point(j, b):
        a = jac_to_affine(F1, j)
        return Point.infinity(b) if a is None else Point(Fq(a[0]), Fq(a[1]), b)


class F2:
    zero, one = (0, 0), (1, 0)

    @staticmethod
    def mul(a, b):
        t0 = a[0] * b[0]
        t1 = a[1] * b[1]
        return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)

    @staticmethod
    def sqr(a):
        return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

    @staticmethod
    def neg(a):
        return (-a[0] % P, -a[1] % P)

    @staticmethod
    def is_zero(a):
        return a[0] == 0 and a[1] == 0

    @staticmethod
    def inv(a):
        n = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
        return (a[0] * n % P, -a[1] * n % P)

    @staticmethod
    def conj(a):
        return (a[0], -a[1] % P)

    @staticmethod
    def from_point(p):
        return ((p.x.c0.n, p.x.c1.n), (p.y.c0.n, p.y.c1.n), (1, 0))

    @staticmethod
    def to_point(j, b):
        a = jac_to_affine(F2, j)
        if a is None:
            return Point.infinity(b)
        return Point(Fq2.from_ints(*a[0]), Fq2.from_ints(*a[1]), b)


def _field_of(p: Point):
    if isinstance(p.x, Fq):
        return F1
    if isinstance(p.x, Fq2):
        return F2
    raise TypeError("Jacobian arithmetic covers points over Fq and Fq2")


def jac_double(F, j):
    """dbl-2009-l (a = 0); infinity and Y = 0 give Z = 0."""
    X, Y, Z = j
    if F.is_zero(Z) or F.is_zero(Y):
        return (F.one, F.one, F.zero)
    A = F.sqr(X)
    B = F.sqr(Y)
    C = F.sqr(B)
    D = F.sub(F.sub(F.sqr(F.add(X, B)), A), C)
    D = F.add(D, D)
    E = F.add(F.add(A, A), A)
    X3 = F.sub(F.sqr(E), F.add(D, D))
    C8 = F.add(C, C)
    C8 = F.add(C8, C8)
    C8 = F.add(C8, C8)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    YZ = F.mul(Y, Z)
    return (X3, Y3, F.add(YZ, YZ))


def jac_add(F, j1, j2):
    """add-2007-bl, complete by case analysis: O + Q, P + O, P + P, P - P."""
    X1, Y1, Z1 = j1
    X2, Y2, Z2 = j2
    if F.is_zero(Z1):
        return j2
    if F.is_zero(Z2):
        return j1
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H = F.sub(U2, U1)
    rr = F.sub(S2, S1)
    if F.is_zero(H):
        return jac_double(F, j1) if F.is_zero(rr) else (F.one, F.one, F.zero)
    I = F.sqr(F.add(H, H))
    J = F.mul(H, I)
    rr = F.add(rr, rr)
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.sqr(rr), J), F.add(V, V))
    SJ = F.mul(S1, J)
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.add(SJ, SJ))
    Z3 = F.mul(F.sub(F.sub(F.sqr(F.add(Z1, Z2)), Z1Z1), Z2Z2), H)
    return (X3, Y3, Z3)


def jac_neg(F, j):
    return (j[0], F.neg(j[1]), j[2])


def jac_mul(F, j, k: int):
    """[k]j for k >= 0, MSB-first double-and-add."""
    if k == 0:
        return (F.one, F.one, F.zero)
    acc = j
    for bit in bin(k)[3:]:
        acc = jac_double(F, acc)
        if bit == "1":
            acc = jac_add(F, acc, j)
    return acc


def jac_to_affine(F, j):
    """(x, y) of a Jacobian point, or None for infinity."""
    X, Y, Z = j
    if F.is_zero(Z):
        return None
    zi = F.inv(Z)
    zi2 = F.sqr(zi)
    return F.mul(X, zi2), F.mul(F.mul(Y, zi2), zi)


# psi = untwist-Frobenius-twist on E2: (x, y) -> (conj(x) * PSI_X, conj(y) * PSI_Y)
_PSI_X_FQ2 = XI.pow((P - 1) // 3).inv()
_PSI_Y_FQ2 = XI.pow((P - 1) // 2).inv()
PSI_X = (_PSI_X_FQ2.c0.n, _PSI_X_FQ2.c1.n)
PSI_Y = (_PSI_Y_FQ2.c0.n, _PSI_Y_FQ2.c1.n)


def psi_jac(j):
    """psi of a Jacobian G2 point: coordinate-wise under conj, no inversion."""
    X, Y, Z = j
    if F2.is_zero(Z):
        return j
    return (F2.mul(F2.conj(X), PSI_X), F2.mul(F2.conj(Y), PSI_Y), F2.conj(Z))


# --- group constructors ----------------------------------------------------


def g1_generator() -> Point:
    return Point(G1_GEN[0], G1_GEN[1], B1)


def g2_generator() -> Point:
    return Point(G2_GEN[0], G2_GEN[1], B2)


def g1_infinity() -> Point:
    return Point.infinity(B1)


def g2_infinity() -> Point:
    return Point.infinity(B2)


def _naf(k: int) -> list[int]:
    """Non-adjacent form of k >= 0, most significant digit first."""
    out = []
    while k:
        if k & 1:
            d = 2 - (k & 3)
            k -= d
        else:
            d = 0
        out.append(d)
        k >>= 1
    return out[::-1]


_R_NAF = _naf(R)


def g1_mul_affine(x: int, y: int, digits: list[int]):
    """Jacobian [k](x, y) on E1 for k given by its signed digits (MSB
    first, leading digit 1): inlined dbl-2009-l and mixed addition
    (madd-2007-bl, Z2 = 1), the inner loop of every G1 subgroup check."""
    X, Y, Z = x, y, 1
    ny = P - y
    for d in digits[1:]:
        if Z == 0:
            X, Y, Z = 1, 1, 0
        elif Y == 0:
            Z = 0
        else:
            A = X * X % P
            B = Y * Y % P
            C = B * B % P
            D = 2 * (((X + B) * (X + B) - A - C) % P)
            E = 3 * A
            X3 = (E * E - 2 * D) % P
            Z = 2 * Y * Z % P
            Y = (E * (D - X3) - 8 * C) % P
            X = X3
        if d:
            y2 = y if d > 0 else ny
            if Z == 0:
                X, Y, Z = x, y2, 1
                continue
            Z1Z1 = Z * Z % P
            U2 = x * Z1Z1 % P
            S2 = y2 * Z * Z1Z1 % P
            H = (U2 - X) % P
            rr = (S2 - Y) % P
            if H == 0:
                if rr == 0:  # doubling of the affine point itself
                    X, Y, Z = jac_double(F1, (x, y2, 1))
                else:
                    X, Y, Z = 1, 1, 0
                continue
            HH = H * H % P
            I = 4 * HH % P
            J = H * I % P
            rr = 2 * rr
            V = X * I % P
            X3 = (rr * rr - J - 2 * V) % P
            Y = (rr * (V - X3) - 2 * Y * J) % P
            Z = ((Z + H) * (Z + H) - Z1Z1 - HH) % P
            X = X3
    return X, Y, Z


def in_subgroup(p: Point) -> bool:
    """Membership in the prime-order subgroup: r*P = O for G1; for G2,
    psi(Q) = -[|x|]Q (Bowe), which holds exactly for the r-torsion."""
    if p.is_infinity():
        return True
    if isinstance(p.x, Fq):
        return g1_mul_affine(p.x.n, p.y.n, _R_NAF)[2] == 0
    if isinstance(p.x, Fq2):
        j = F2.from_point(p)
        z = jac_to_affine(F2, jac_mul(F2, j, BLS_X_ABS))
        if z is None:
            return False
        px, py, _ = psi_jac(j)
        return z[0] == px and F2.neg(z[1]) == py
    return p.mul(R).is_infinity()


# --- compressed serialization ---------------------------------------------
# Flag bits on the first byte: 0x80 compressed, 0x40 infinity, 0x20 largest-y.


def g1_to_bytes(p: Point) -> bytes:
    if p.is_infinity():
        return bytes([0xC0]) + b"\x00" * 47
    data = bytearray(p.x.n.to_bytes(48, "big"))
    data[0] |= 0x80
    if p.y.sign():
        data[0] |= 0x20
    return bytes(data)


def g1_from_bytes(data: bytes, subgroup_check: bool = True) -> Point:
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G1 encoding not supported")
    if flags & 0x40:
        if any(data[1:]) or flags & 0x3F:
            raise ValueError("malformed G1 infinity encoding")
        return g1_infinity()
    xn = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if xn >= P:
        raise ValueError("G1 x coordinate out of range")
    x = Fq(xn)
    y2 = x.square() * x + B1
    y = y2.sqrt()
    if y is None:
        raise ValueError("G1 x coordinate not on curve")
    if y.sign() != (1 if flags & 0x20 else 0):
        y = -y
    p = Point(x, y, B1)
    if subgroup_check and not in_subgroup(p):
        raise ValueError("G1 point not in the prime-order subgroup")
    return p


def g2_to_bytes(p: Point) -> bytes:
    if p.is_infinity():
        return bytes([0xC0]) + b"\x00" * 95
    data = bytearray(p.x.c1.n.to_bytes(48, "big") + p.x.c0.n.to_bytes(48, "big"))
    data[0] |= 0x80
    if p.y.sign():
        data[0] |= 0x20
    return bytes(data)


def g2_from_bytes(data: bytes, subgroup_check: bool = True) -> Point:
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G2 encoding not supported")
    if flags & 0x40:
        if any(data[1:]) or flags & 0x3F:
            raise ValueError("malformed G2 infinity encoding")
        return g2_infinity()
    x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x coordinate out of range")
    x = Fq2(Fq(x0), Fq(x1))
    y2 = x.square() * x + B2
    y = y2.sqrt()
    if y is None:
        raise ValueError("G2 x coordinate not on curve")
    if y.sign() != (1 if flags & 0x20 else 0):
        y = -y
    p = Point(x, y, B2)
    if subgroup_check and not in_subgroup(p):
        raise ValueError("G2 point not in the prime-order subgroup")
    return p
