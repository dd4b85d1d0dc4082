"""The plain reference that decides `correct`: plain Python, NumPy and
torch, importing nothing of the program under test."""
