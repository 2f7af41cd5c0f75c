"""The plain PyTorch reference the benchmark judges the program against."""
