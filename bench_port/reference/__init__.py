"""The plain reference that decides ``correct``: NumPy and PyTorch only.
It imports nothing of the program under test and works out again, from a
configuration's numbers, everything the program derives in its set-up."""
