"""Multi-epoch runners of the port (counterparts of
``eth_consensus_specs_tpu/parallel``)."""
