"""The serving side of the port (counterparts of
``eth_consensus_specs_tpu/serve``)."""
