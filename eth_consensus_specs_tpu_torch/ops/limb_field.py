"""The BLS12-381 scalar field Fr on int64 torch lanes: the plain version of
the card's Fr (``csrc/fr.cuh``).

Counterpart of ``eth_consensus_specs_tpu/ops/limb_field.py`` (``LimbField``
:24 at the 255-bit r: 9 x 30-bit Montgomery limbs, R = 2^270, values in
[0, 2r)). Here an element is ``int64[..., 10]``: ten 26-bit limbs,
little-endian, always canonical (value in [0, r), every limb in [0, 2^26)).
26-bit limbs keep every lane far from 2^63: a limb product is below 2^52, a
product column of ten below 2^56, and the Montgomery reduction's additions
stay below 2^58. (The JAX layout's 30-bit columns reach 9 * (2^30 - 1)^2
plus carries, above 2^63, where an arithmetic ``>>`` of an int64 lane gives
wrong carries.) The Montgomery radix is R = 2^260.

The card keeps Fr as 8 x 32-bit words in Montgomery form with R = 2^256.
The two meet only in ``int32[..., 8]`` little-endian u32 words: canonical
values (``from_words`` / ``to_words``), or the card's Montgomery form
x * 2^256 mod r for constants (``from_card_words``, which gives this
module's Montgomery form x * 2^260 mod r). Limb arrays never compare across
the packages, only ints and words.
"""

from __future__ import annotations

import numpy as np
import torch

R_MOD = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
LIMB_BITS = 26
N_LIMBS = 10  # 260 bits >= 255
MASK = (1 << LIMB_BITS) - 1
R_INT = 1 << (LIMB_BITS * N_LIMBS)  # this module's Montgomery radix, 2^260
N0 = (-pow(R_MOD, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
N_WORDS = 8  # u32 words at the kernels' boundary
CARD_R = 1 << 256  # the card's Montgomery radix (csrc/fr.cuh)


def int_to_limbs(x: int) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & MASK for i in range(N_LIMBS)]


_CONST: dict = {}


def _const(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    hit = _CONST.get(key)
    if hit is None:
        # card_in: w * 2^264 / 2^260 = x * 2^260 for w = x * 2^256
        val = {"r": R_MOD, "card_in": pow(2, 264, R_MOD)}[name]
        hit = _CONST[key] = torch.tensor(int_to_limbs(val), dtype=torch.int64, device=device)
    return hit


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Sequential carry pass over the limb axis (signed: a borrow moves as
    a negative carry); the top limb keeps what is left."""
    t = t.clone()
    for k in range(N_LIMBS - 1):
        t[..., k + 1] += t[..., k] >> LIMB_BITS
        t[..., k] &= MASK
    return t


def _reduce_once(t: torch.Tensor) -> torch.Tensor:
    """Normalized limbs of a value in [0, 2r) -> canonical (value < r)."""
    d = _carry(t - _const("r", t.device))
    return torch.where((d[..., -1] < 0).unsqueeze(-1), t, d)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce_once(_carry(a + b))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = _carry(a - b)
    return torch.where((d[..., -1] < 0).unsqueeze(-1), _carry(d + _const("r", d.device)), d)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b / 2^260 mod r of canonical operands (broadcast); canonical."""
    a, b = torch.broadcast_tensors(a, b)
    outer = a.unsqueeze(-1) * b.unsqueeze(-2)  # [..., 10, 10]
    # skew row i right by i, then sum the rows: the 19 product columns
    skew = torch.nn.functional.pad(outer, (0, N_LIMBS)).flatten(-2)
    skew = skew[..., : N_LIMBS * (2 * N_LIMBS - 1)].unflatten(-1, (N_LIMBS, 2 * N_LIMBS - 1))
    t = torch.nn.functional.pad(skew.sum(dim=-2), (0, 1)).movedim(-1, 0).contiguous()
    r = _const("r", a.device).reshape(N_LIMBS, *([1] * (t.dim() - 1)))
    rows = t.unbind(0)
    for i in range(N_LIMBS):
        m = ((rows[i] & MASK) * N0) & MASK
        t.narrow(0, i, N_LIMBS).add_(m * r)
        rows[i + 1].add_(rows[i] >> LIMB_BITS)
    hi = t[N_LIMBS:]
    for k in range(N_LIMBS - 1):  # value < 2r: normalize, then one subtraction
        hi[k + 1] += hi[k] >> LIMB_BITS
        hi[k] &= MASK
    return _reduce_once(hi.movedim(0, -1))


# --- u32 words at the kernels' boundary ---------------------------------------

_W2L = [(26 * k // 32, 26 * k % 32) for k in range(N_LIMBS)]
_L2W = [(32 * j // 26, 32 * j % 26) for j in range(N_WORDS)]


def from_words(w: torch.Tensor) -> torch.Tensor:
    """int32[..., 8] little-endian u32 words -> limbs of the same value."""
    u = torch.nn.functional.pad(w.to(torch.int64) & 0xFFFFFFFF, (0, 1))
    return torch.stack([((u[..., q] >> off) | (u[..., q + 1] << (32 - off))) & MASK
                        for q, off in _W2L], dim=-1)


def to_words(c: torch.Tensor) -> torch.Tensor:
    """Canonical limbs -> int32[..., 8] little-endian u32 words."""
    c = torch.nn.functional.pad(c, (0, 2))
    words = [(c[..., q] >> off) | (c[..., q + 1] << (26 - off)) | (c[..., q + 2] << (52 - off))
             for q, off in _L2W]
    w = torch.stack(words, dim=-1) & 0xFFFFFFFF
    return (w - ((w >> 31) << 32)).to(torch.int32)


def from_card_words(w: torch.Tensor) -> torch.Tensor:
    """Words of the card's Montgomery form x * 2^256 mod r -> this module's
    Montgomery form x * 2^260 mod r (limbs): one product."""
    return mont_mul(from_words(w), _const("card_in", w.device))


def ints_to_words(vals) -> np.ndarray:
    """Ints in [0, 2^256) (a flat or nested list) -> numpy int32[..., 8]."""
    arr = np.asarray(vals, dtype=object)
    buf = b"".join(int(v).to_bytes(32, "little") for v in arr.reshape(-1))
    words = np.frombuffer(buf, dtype="<u4").astype(np.uint32).view(np.int32)
    return words.reshape(*arr.shape, N_WORDS)


def words_to_ints(w) -> list:
    """int32[..., 8] words (tensor or numpy) -> a flat list of ints."""
    a = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
    buf = np.ascontiguousarray(a.astype(np.int32)).view(np.uint32).astype("<u4").tobytes()
    return [int.from_bytes(buf[i:i + 32], "little") for i in range(0, len(buf), 32)]


def ints_to_card_words(vals) -> np.ndarray:
    """Canonical ints -> numpy int32[..., 8] words of the card's Montgomery
    form x * 2^256 mod r."""
    arr = np.asarray(vals, dtype=object)
    return ints_to_words(np.vectorize(lambda x: int(x) * CARD_R % R_MOD, otypes=[object])(arr))


def big_endian_to_words(data: bytes, count: int) -> np.ndarray:
    """``count`` big-endian 32-byte field elements (a blob's bytes) -> numpy
    int32[count, 8] little-endian u32 words, by one byte swap and one word
    reversal, no Python ints."""
    be = np.frombuffer(data, dtype=">u4", count=count * N_WORDS).reshape(count, N_WORDS)
    return np.ascontiguousarray(be[:, ::-1]).astype(np.uint32).view(np.int32)
