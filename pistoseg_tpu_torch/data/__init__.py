"""Datasets, label grammars and the host batch loader."""
