"""Plain PyTorch reference of what the cells render; it imports nothing
of the program."""
