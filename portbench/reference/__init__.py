"""Plain PyTorch references of the protocols the cells run.  They import
nothing of the program and take only the benchmark's own inputs; every
float tensor is in the ``dtype`` given, so the same code in a lower
precision is the control that the comparison must fail."""
