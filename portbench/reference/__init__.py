"""The plain reference the benchmark holds the program to: plain PyTorch,
written from the published recipes, importing nothing of the program."""
