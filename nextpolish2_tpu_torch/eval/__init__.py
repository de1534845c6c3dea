"""Evaluation of polished assemblies (QV against a short-read k-mer table)."""
