"""The plain reference the benchmark holds the polisher's output to."""
