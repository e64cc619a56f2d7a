"""Operation and byte counts of the program's kernels, and the card's
peaks, from which a kernel's share of its roofline is reckoned."""
