"""The host FFT over the BLS scalar field: the oracle of kernel K16.

The port's copy of ``fft_field`` and ``_fft_iter`` from
``eth_consensus_specs_tpu/crypto/das.py`` (spec
specs/fulu/polynomial-commitments-sampling.md:140-171): an iterative
radix-2 DIT over flat scalar lists, bit-exact with the spec's recursion.
The JAX module's device seam (``set_device_fft``, routing ``fft_field`` to
the device FFT above 512 points) and the rest of the DAS extension are not
ported yet; here ``fft_field`` is the host reference only.
"""

from __future__ import annotations

from .fields import R as BLS_MODULUS
from .kzg import bit_reversal_permutation

_P = BLS_MODULUS


def _fft_iter(vals: list[int], roots: tuple[int, ...]) -> list[int]:
    """Iterative radix-2 DIT: o[i] = sum_j vals[j] * roots[1]^(i*j)."""
    n = len(vals)
    assert n == len(roots) and n & (n - 1) == 0
    if n == 1:
        return list(vals)
    out = bit_reversal_permutation(list(vals))
    m = 1
    while m < n:
        stride = n // (2 * m)
        for start in range(0, n, 2 * m):
            for k in range(m):
                w = roots[k * stride]
                a = out[start + k]
                b = out[start + k + m] * w % _P
                out[start + k] = (a + b) % _P
                out[start + k + m] = (a - b) % _P
        m *= 2
    return out


def fft_field(vals, roots_of_unity, inv: bool = False) -> list[int]:
    """specs/fulu/polynomial-commitments-sampling.md:158-171."""
    roots = tuple(roots_of_unity)
    if inv:
        invlen = pow(len(vals), _P - 2, _P)
        inv_roots = (roots[0],) + roots[:0:-1]
        return [x * invlen % _P for x in _fft_iter(list(vals), inv_roots)]
    return _fft_iter(list(vals), roots)
