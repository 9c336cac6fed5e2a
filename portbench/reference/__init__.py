"""Plain PyTorch references of the mathematics the cells run, written from
the models' equations and not from the program: they import nothing of
`fidelityfusion_tpu_torch`, `fidelityfusion_tpu` or JAX, and take from a
run only its inputs and, to be judged, its outputs."""
