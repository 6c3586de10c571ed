"""MVDeTr in plain PyTorch and numpy: the yardstick the program is held against. Imports nothing of the program."""
