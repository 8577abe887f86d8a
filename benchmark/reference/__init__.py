"""The plain references the benchmark holds the program to: ``torch.nn`` and
numpy only, nothing of the program, of JAX or of the JAX package."""
