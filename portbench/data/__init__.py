"""Input generators of the benchmark: frozen numpy copies of the formulas
the cells use, so an edit of the program cannot move its inputs."""
