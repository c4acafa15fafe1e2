"""The plain reference the check holds the program to: the ANI potential
(ani.py) and the MD step (integrate.py), plain PyTorch, nothing of the
program under test."""
