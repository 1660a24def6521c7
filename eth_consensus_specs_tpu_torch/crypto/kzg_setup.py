"""Deterministic INSECURE KZG trusted setup for testing.

The port's copy of ``eth_consensus_specs_tpu/crypto/kzg_setup.py``. The
production setup is the output of the public powers-of-tau ceremony; this
package ships a self-generated test setup instead (same shape: G1 monomial
+ G1 Lagrange + G2 monomial), with tau derived from a fixed tag, so the
discrete log is public by construction, which is exactly what a *testing*
setup is.

Lagrange points are computed directly in the scalar field:
    L_i(tau) = omega^i * (tau^n - 1) / (n * (tau - omega^i))
then lifted to G1 with one scalar multiplication each.

The shipped file (``data/trusted_setups/insecure_testing_setup_4096.json``
inside this package) is byte for byte the JAX package's, and
``json.dump(generate_setup(), f)`` rebuilds it deterministically.
"""

from __future__ import annotations

import hashlib
import os

from .curve import g1_generator, g1_to_bytes, g2_generator, g2_to_bytes
from .fields import R

SETUP_TAG = b"eth-consensus-specs-tpu insecure kzg testing setup v1"
PRIMITIVE_ROOT_OF_UNITY = 7

# embedded in every generated setup file as its first key, so the
# provenance travels with the artifact; the text is the JAX package's, so a
# regenerated file stays byte-equal to the one it ships
PROVENANCE = (
    "INSECURE TESTING SETUP — do not use in production. tau = "
    "sha256({tag}) mod r is derived from a public tag, so the trapdoor "
    "discrete log is public by construction; anyone can forge proofs "
    "under this setup. Generated by scripts/gen_kzg_trusted_setup.py "
    "(crypto/kzg_setup.py); the production analogue is the public "
    "powers-of-tau ceremony output."
).format(tag=SETUP_TAG.decode())

_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "trusted_setups")


def testing_tau() -> int:
    return int.from_bytes(hashlib.sha256(SETUP_TAG).digest(), "big") % R


def generate_setup(n: int = 4096, g2_length: int = 65) -> dict:
    tau = testing_tau()
    g1 = g1_generator()
    g2 = g2_generator()

    powers = []
    acc = 1
    for _ in range(n):
        powers.append(acc)
        acc = acc * tau % R

    root = pow(PRIMITIVE_ROOT_OF_UNITY, (R - 1) // n, R)
    omegas = []
    acc = 1
    for _ in range(n):
        omegas.append(acc)
        acc = acc * root % R

    tau_n_minus_1 = (pow(tau, n, R) - 1) % R
    n_inv = pow(n, R - 2, R)
    lagrange_scalars = [
        omegas[i] * tau_n_minus_1 % R * pow((tau - omegas[i]) % R, R - 2, R) % R * n_inv % R
        for i in range(n)
    ]

    return {
        "provenance": PROVENANCE,
        "g1_monomial": ["0x" + g1_to_bytes(g1.mul(p)).hex() for p in powers],
        "g1_lagrange": ["0x" + g1_to_bytes(g1.mul(s)).hex() for s in lagrange_scalars],
        "g2_monomial": [
            "0x" + g2_to_bytes(g2.mul(pow(tau, i, R))).hex() for i in range(g2_length)
        ],
    }


def setup_path(n: int = 4096) -> str:
    return os.path.join(_DATA_DIR, f"insecure_testing_setup_{n}.json")
