"""The port's counterparts of the JAX package's `examples/`, run as
`python -m raysnail_tpu_torch.examples.<name>`: inverse_rendering,
rtow_13_1 and preview."""
