"""The plain reference: a straightforward ray tracer of the same semantics, in plain PyTorch, independent of the program."""
