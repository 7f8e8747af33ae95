"""The plain reference the benchmark holds the program's answers against."""
