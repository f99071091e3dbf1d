"""Plain references of the cells: PyTorch in f64, nothing of the program."""
