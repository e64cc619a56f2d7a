"""Plain references the benchmark judges the program by. Nothing here
imports the program, JAX or the JAX package."""
