"""Measurement scripts for the port that are not part of its main path."""
