"""The plain PyTorch reference that decides ``correct``; it imports nothing
of the program."""
