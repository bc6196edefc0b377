"""The frozen arithmetic of the benchmark: the card's peaks, the model
FLOPs of a step, and the least time of each flash kernel. Later changes to
the program cannot move these: a reading's denominator stays the same."""
