"""Device ops of the port, one module per counterpart in
``eth_consensus_specs_tpu/ops``."""
