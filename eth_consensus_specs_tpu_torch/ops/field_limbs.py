"""BLS12-381 base-field arithmetic on int64 torch lanes: the plain versions.

Counterpart of ``eth_consensus_specs_tpu/ops/field_limbs.py`` and
``ops/lazy_limbs.py``. An element of Fq is ``int64[..., 15]``: fifteen
26-bit limbs, little-endian, in Montgomery form with R = 2^390 (the JAX
package's radix too). Between operations an element is loose (see the note
above ``add``): signed limbs a little over 26 bits and a value within a few
multiples of p, so a product of two limbs stays under 2^58 and a column of
fifteen under 2^62, and no lane crosses 2^63. (The JAX 13 x 30-bit layout
does, and this torch build has no unsigned shift or compare.) Additions are
one tensor op; the Montgomery reduction is the one sequential loop, fifteen
steps of one quotient limb each; ``canon`` gives the exact canonical limbs
where elements are compared or leave the module (carries resolved in
parallel by ``_settle``, a lookahead over a ``cummax``). Every operation is
batched over the leading dimensions.

The card's kernels use their own layout (12 x 32-bit limbs, R = 2^384, in
``csrc/bls_fp.cuh``). The two never share limbs: they exchange
``int32[..., 12]`` little-endian u32 words, either canonical values
(``from_words`` and ``to_words``: K11 and K12) or the card's Montgomery form
x * 2^384 mod p (``from_card_words`` and ``to_card_words``: K10, whose lanes
are cached key rows in that form; ``ints_to_card_words`` and
``card_words_to_ints`` on the host).
"""

from __future__ import annotations

import torch

from ..crypto.fields import P as P_INT

LIMB_BITS = 26
N_LIMBS = 15  # 15 * 26 = 390 >= 381
MASK = (1 << LIMB_BITS) - 1
R_INT = 1 << (LIMB_BITS * N_LIMBS)  # Montgomery radix 2^390
N0 = (-pow(P_INT, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
N_WORDS = 12  # u32 words at the kernels' boundary
CARD_R = 1 << 384  # the kernels' Montgomery radix (csrc/bls_fp.cuh)


def int_to_limbs(x: int) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & MASK for i in range(N_LIMBS)]


def limbs_to_int(row) -> int:
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(row))


_CONST: dict = {}


def _const(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    hit = _CONST.get(key)
    if hit is None:
        val = {"p": P_INT, "r2": R_INT * R_INT % P_INT, "one": R_INT % P_INT, "raw_one": 1,
               # w * 2^396 / R = x * R for w = x * 2^384; a * 2^384 / R = x * 2^384 for a = x * R
               "card_in": pow(2, 396, P_INT), "card_out": CARD_R % P_INT}[name]
        hit = _CONST[key] = torch.tensor(int_to_limbs(val), dtype=torch.int64, device=device)
    return hit


def from_ints(vals, device="cpu") -> torch.Tensor:
    """Canonical ints (nested lists allowed) -> Montgomery limbs."""
    def conv(v):
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return int_to_limbs(int(v) * R_INT % P_INT)

    return torch.tensor(conv(vals), dtype=torch.int64, device=device)


def to_ints(a: torch.Tensor):
    """Montgomery limbs -> canonical ints, nested like the leading dims."""
    rinv = pow(R_INT, -1, P_INT)
    rows = canon(a.detach().cpu()).reshape(-1, N_LIMBS).tolist()
    flat = [limbs_to_int(r) * rinv % P_INT for r in rows]
    return _nest(flat, list(a.shape[:-1]))


def _settle(lo: torch.Tensor, gen: torch.Tensor, prop: torch.Tensor, sign: int) -> tuple:
    """Resolve one-bit carries (sign +1) or borrows (-1) in parallel.

    ``lo`` holds limbs in [0, 2^26); limb i generates a carry out (``gen``)
    or passes one on (``prop``), never both. The carry into limb i is the
    ``gen`` of the last limb below i that does not propagate. Returns the
    normalized limbs and the carry out of the top limb."""
    idx = torch.arange(N_LIMBS, device=lo.device).expand_as(lo)
    last = torch.where(prop, torch.full_like(idx, -1), idx).cummax(dim=-1).values
    below = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]], dim=-1)
    cin = torch.gather(gen, -1, below.clamp(min=0)) & (below >= 0)
    out = (lo + sign * cin.to(lo.dtype)) & MASK
    top = last[..., -1]
    cout = torch.gather(gen, -1, top.clamp(min=0).unsqueeze(-1)).squeeze(-1) & (top >= 0)
    return out, cout


def _pass(r: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass: every limb but the top keeps its low 26
    bits and hands the rest (a signed floor) to the next; the top limb keeps
    everything. The value is unchanged."""
    out = torch.cat([r[..., :-1] & MASK, r[..., -1:]], dim=-1)
    out[..., 1:] += r[..., :-1] >> LIMB_BITS
    return out


# --- loose elements -------------------------------------------------------------
# Inside the tower an element is loose: its limbs are signed and may exceed 26
# bits, its value any integer congruent to the element. ``add``, ``sub`` and
# ``neg`` are one tensor op each. ``mul`` takes loose operands whose limbs
# multiply to under 2^58 (a column of fifteen and the reduction's additions
# stay under 2^63) and returns limbs within 2^26 + 2^6 and a value in
# (-p, 2p). ``norm`` brings a longer chain of additions back to that.
# ``canon`` gives the exact, canonical limbs that comparisons and the
# boundary conversions need.


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def dbl(a: torch.Tensor) -> torch.Tensor:
    return a + a


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b


def neg(a: torch.Tensor) -> torch.Tensor:
    return -a


_P_HI = P_INT >> (LIMB_BITS * (N_LIMBS - 2))  # p's top 43 bits


def norm(a: torch.Tensor) -> torch.Tensor:
    """A loose element with limbs near 26 bits and value in [0, 2p): one
    carry pass, then q*p subtracted, q estimated from the top two limbs."""
    r = _pass(a)
    top = (r[..., -1] << LIMB_BITS) + r[..., -2]
    q = torch.div(top, _P_HI + 1, rounding_mode="floor")
    return _pass(r - q.unsqueeze(-1) * _const("p", a.device))


def canon(a: torch.Tensor) -> torch.Tensor:
    """The canonical limbs of a loose element: value in [0, p), every limb
    in [0, 2^26)."""
    p = _const("p", a.device)
    r = norm(a) + p  # value in (0, 3p)
    for i in range(N_LIMBS - 1):
        r[..., i + 1] += r[..., i] >> LIMB_BITS
        r[..., i] &= MASK
    for _ in range(2):
        d = r - p
        d, borrow = _settle(d & MASK, d < 0, d == 0, -1)
        r = torch.where(borrow.unsqueeze(-1), r, d)
    return r


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b / R of loose operands (broadcast)."""
    a, b = torch.broadcast_tensors(a, b)
    outer = a.unsqueeze(-1) * b.unsqueeze(-2)  # [..., 15, 15]
    # skew row i right by i, then sum the rows: the 29 product columns
    skew = torch.nn.functional.pad(outer, (0, N_LIMBS)).flatten(-2)
    skew = skew[..., : N_LIMBS * (2 * N_LIMBS - 1)].unflatten(-1, (N_LIMBS, 2 * N_LIMBS - 1))
    # columns first, so each reduction step updates contiguous rows in place
    t = torch.nn.functional.pad(skew.sum(dim=-2), (0, 1)).movedim(-1, 0).contiguous()
    p = _const("p", a.device).reshape(N_LIMBS, *([1] * (t.dim() - 1)))
    rows = t.unbind(0)
    for i in range(N_LIMBS):
        m = ((rows[i] & MASK) * N0) & MASK
        t.narrow(0, i, N_LIMBS).add_(m * p)
        rows[i + 1].add_(rows[i] >> LIMB_BITS)
    return _pass(_pass(t[N_LIMBS:].movedim(0, -1)))


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Canonical limbs (value < p) -> Montgomery form."""
    return mul(a, _const("r2", a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical limbs."""
    return canon(mul(a, _const("raw_one", a.device)))


def one_like(a: torch.Tensor) -> torch.Tensor:
    return _const("one", a.device).expand_as(a).clone()


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (canon(a) == 0).all(dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_zero(a - b)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element mask ? a : b over the limb axis."""
    return torch.where(mask.unsqueeze(-1), a, b)


_P_MINUS_2 = P_INT - 2
_WINDOW = 4


def inv(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p-2), four-bit fixed window; 0 maps to 0."""
    table = [one_like(a), norm(a)]
    for _ in range(2, 1 << _WINDOW):
        table.append(mul(table[-1], table[1]))
    acc = None
    nbits = _P_MINUS_2.bit_length()
    top = (nbits + _WINDOW - 1) // _WINDOW * _WINDOW
    for shift in range(top - _WINDOW, -1, -_WINDOW):
        digit = (_P_MINUS_2 >> shift) & ((1 << _WINDOW) - 1)
        if acc is None:
            acc = table[digit]
            continue
        for _ in range(_WINDOW):
            acc = sqr(acc)
        if digit:
            acc = mul(acc, table[digit])
    return acc


# --- u32 words at the kernels' boundary ---------------------------------------

_W2L = [(26 * k // 32, 26 * k % 32) for k in range(N_LIMBS)]
_L2W = [(32 * j // 26, 32 * j % 26) for j in range(N_WORDS)]
_CARD_RINV = pow(CARD_R, -1, P_INT)


def _raw_limbs(w: torch.Tensor) -> torch.Tensor:
    """int32[..., 12] u32 words -> limbs of the same value (not Montgomery)."""
    u = torch.nn.functional.pad(w.to(torch.int64) & 0xFFFFFFFF, (0, 1))
    return torch.stack([((u[..., q] >> off) | (u[..., q + 1] << (32 - off))) & MASK
                        for q, off in _W2L], dim=-1)


def _raw_words(c: torch.Tensor) -> torch.Tensor:
    """Canonical limbs (each < 2^26) -> int32[..., 12] u32 words."""
    c = torch.nn.functional.pad(c, (0, 2))
    words = [(c[..., q] >> off) | (c[..., q + 1] << (26 - off)) | (c[..., q + 2] << (52 - off))
             for q, off in _L2W]
    w = torch.stack(words, dim=-1) & 0xFFFFFFFF
    return (w - ((w >> 31) << 32)).to(torch.int32)


def from_words(w: torch.Tensor) -> torch.Tensor:
    """int32[..., 12] canonical little-endian u32 words -> Montgomery limbs."""
    return to_mont(_raw_limbs(w))


def to_words(a: torch.Tensor) -> torch.Tensor:
    """Montgomery limbs -> int32[..., 12] canonical little-endian u32 words."""
    return _raw_words(from_mont(a))


def from_card_words(w: torch.Tensor) -> torch.Tensor:
    """int32[..., 12] words of the card's Montgomery form (x * 2^384 mod p)
    -> Montgomery limbs of x: one product."""
    return mul(_raw_limbs(w), _const("card_in", w.device))


def to_card_words(a: torch.Tensor) -> torch.Tensor:
    """Montgomery limbs of x -> int32[..., 12] words of x * 2^384 mod p."""
    return _raw_words(canon(mul(a, _const("card_out", a.device))))


def ints_to_words(vals) -> "numpy.ndarray":  # noqa: F821
    """Canonical ints (nested) -> numpy int32[..., 12] u32 words."""
    import numpy as np

    def conv(v):
        if isinstance(v, (list, tuple)):
            return b"".join(conv(x) for x in v)
        return int(v).to_bytes(48, "little")

    shape = _shape(vals)
    words = np.frombuffer(conv(vals), dtype="<u4").astype(np.uint32).view(np.int32)
    return words.reshape(*shape, N_WORDS)


def words_to_ints(w):
    """int32[..., 12] words (tensor or numpy) -> the ints they hold, nested."""
    import numpy as np

    a = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
    a = a.astype(np.int32)
    flat = [int.from_bytes(r.astype("<u4").tobytes(), "little")
            for r in a.view(np.uint32).reshape(-1, N_WORDS)]
    return _nest(flat, list(a.shape[:-1]))


def _nest(items: list, shape: list):
    if not shape:
        return items[0]
    step = len(items) // shape[0]
    return [_nest(items[i * step:(i + 1) * step], shape[1:]) for i in range(shape[0])]


def _map_nested(fn, v):
    return [_map_nested(fn, x) for x in v] if isinstance(v, (list, tuple)) else fn(v)


def ints_to_card_words(vals) -> "numpy.ndarray":  # noqa: F821
    """Canonical ints (nested) -> numpy int32[..., 12] words of the card's
    Montgomery form."""
    return ints_to_words(_map_nested(lambda x: int(x) * CARD_R % P_INT, vals))


def card_words_to_ints(w):
    """Words of the card's Montgomery form -> canonical ints, nested."""
    return _map_nested(lambda x: x * _CARD_RINV % P_INT, words_to_ints(w))


def _shape(v) -> list[int]:
    return [len(v), *_shape(v[0])] if isinstance(v, (list, tuple)) else []
