"""The benchmark of `fidelityfusion_tpu_torch` on NVIDIA GPUs.

Everything that measures the port and decides whether its output is
correct lives here, apart from the program: data generators, plain float64
references, FLOP and byte counts, trace readers.  A cell is found by its
name: `workloads/<cell>.json` names a configuration (`configs/<name>.json`)
and a traffic mix (`traffic/<name>.json`), the mix names a driver
(`drivers/<driver>.py`), and each per-layer metric is a reader of its own
(`metrics/<metric>.py`).  Nothing here imports JAX or the JAX package.
"""
