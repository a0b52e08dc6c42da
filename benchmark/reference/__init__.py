"""Plain PyTorch references that decide `correct`. They import nothing of
the program: the same equations, written out from the published
descriptions, in fp32 with TF32 off."""
