"""The plain references the benchmark compares the program with."""
