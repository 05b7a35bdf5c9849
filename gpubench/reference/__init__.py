"""The benchmark's plain reference: pair selection, orientation, exact
alignment and PAF records worked out again from a job's FASTA, in NumPy
and plain PyTorch, with nothing of the program imported."""
