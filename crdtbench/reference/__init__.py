"""The plain reference the benchmark holds the program to.

Plain PyTorch, written from the paper (Enes et al. 2018, Algorithms 1-2 and
the anti-entropy resync of DESIGN.md §14) and from the generated inputs
alone. It imports nothing of the program under test.
"""
