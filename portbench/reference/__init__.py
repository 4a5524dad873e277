"""The plain reference: PyTorch and numpy only, nothing of the program."""
