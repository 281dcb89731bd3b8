"""Plain PyTorch references of the configurations' mathematics: the
frontend (``fpca``) and the gated camera stream (``gate``).  They import
nothing of the program under test."""
