"""The plain reference of the benchmark: the Splendor env, the v1 net, the
fresh-tree search and the self-play actor in plain PyTorch and NumPy, and
the checkpoint reader.  Nothing here imports the program
(``alphazero_tpu_torch``), JAX or the JAX package."""
