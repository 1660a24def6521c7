"""Host BLS12-381 crypto of the port: its own pure-Python copy of the JAX
package's ``crypto`` modules (fields, curve groups, hash-to-G2, the pairing
oracle and the signature verbs), with no native core underneath."""
