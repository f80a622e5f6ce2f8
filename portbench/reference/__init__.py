"""Plain references, one per architecture family: straightforward torch in
float32, with no kernel, cache or batching of the program, and no import
of the program or of the JAX package.  Each takes the configuration
file's contents and the weights the benchmark made."""
