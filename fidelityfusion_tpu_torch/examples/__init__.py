"""User-facing drives of the port, one per `examples/0N_*.py` of the JAX
package: ``python -m fidelityfusion_tpu_torch.examples.ex0N_... [--device cpu]``."""
