"""The plain references: each family's forward in float32 PyTorch, with
no kernel, no cache and no batching, and nothing of the program."""
