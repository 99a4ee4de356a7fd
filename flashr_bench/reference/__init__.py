"""The plain reference that decides ``correct``: plain PyTorch, importing
nothing of the program."""
