"""The plain reference of the benchmark: dmft-lanc-ed's normal-bath
Anderson impurity model and its DMFT loop in NumPy/SciPy alone. It
imports nothing of the program under test."""
