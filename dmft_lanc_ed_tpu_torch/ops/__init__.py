"""Sector operators and Krylov solvers of the PyTorch port."""
