"""Plain PyTorch references of the models the benchmark serves. They read
the weights the benchmark made and nothing of the program."""
