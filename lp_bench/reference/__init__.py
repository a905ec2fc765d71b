"""Plain references (NumPy, SciPy, PyTorch) that decide ``correct``; they
import nothing of the system under test."""
